"""Shows that chip_smoke.py's entropy gates reject broken entropy kernels.

    python3 scripts/entropy_gate_mutants.py      # needs one CUDA card

For each fault below (and once without one) the script copies
``src/repro_torch`` into a temporary directory, plants the fault in the
copy's ``csrc/entropy.cu``, and in a fresh process builds that copy's
kernel and runs it over chip_smoke.py's entropy cases (``entropy_inputs``)
against the plain version, through chip_smoke.py's own gate
(``entropy_fault``). It prints one JSON line per fault: the largest error
and, per case, what the gate said. It exits non-zero if the unchanged
kernel fails a case or a faulty one passes every case. The repo itself is
never changed.

Faults:
  drop_partial  the final pass merges all but the last pass-1 partial;
  drop_tail     pass 1 skips the elements past its last 16-byte load;
  drop_sz       the final pass writes m + log Z, without the - S/Z term.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]

FAULTS = {
    "none": None,
    "drop_partial": ("for (int i = threadIdx.x; i < nparts; i += kThreads)",
                     "for (int i = threadIdx.x; i < nparts - 1; "
                     "i += kThreads)"),
    "drop_tail": ("tail = nv * kPer;", "tail = n;"),
    "drop_sz": ("out[0] = (st.m + logf(st.z)) - st.s / st.z;",
                "out[0] = st.m + logf(st.z);"),
}

# run in the child process, with the copy's src/ first on sys.path
CHILD = r"""
import json, sys, torch
import chip_smoke as C
from repro_torch.kernels.entropy import ops as EN
assert EN.__file__.startswith(sys.argv[1]), EN.__file__
gen = torch.Generator(device="cuda").manual_seed(0)
cases = []
for label, w in C.entropy_inputs(torch, gen):
    got = float(EN.entropy_cuda(w))
    want = float(EN.matrix_entropy(w, plain=True))
    cases.append(dict(case=label, err=abs(got - want),
                      fault=C.entropy_fault(got, want)))
print(json.dumps(cases))
"""


def run(fault: str, edit) -> dict:
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="entropy_mutant_"))
    try:
        src = tmp / "src" / "repro_torch"
        shutil.copytree(ROOT / "src" / "repro_torch", src,
                        ignore=shutil.ignore_patterns("__pycache__"))
        cu = src / "csrc" / "entropy.cu"
        if edit is not None:
            text = cu.read_text()
            if text.count(edit[0]) != 1:
                raise SystemExit(f"{fault}: the text to change is not in "
                                 f"entropy.cu once: {edit[0]!r}")
            cu.write_text(text.replace(edit[0], edit[1]))
        env = dict(os.environ,
                   PYTHONPATH=os.pathsep.join([str(tmp / "src"), str(ROOT)]))
        out = subprocess.run([sys.executable, "-c", CHILD, str(tmp)],
                             env=env, capture_output=True, text=True,
                             timeout=600)
        if out.returncode:
            raise SystemExit(f"{fault}: the run failed\n{out.stderr[-4000:]}")
        cases = json.loads(out.stdout.strip().splitlines()[-1])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    caught = [c["case"] for c in cases if c["fault"]]
    return dict(fault=fault, max_err=max(c["err"] for c in cases),
                caught_in=caught, cases=cases)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("entropy_gate_mutants: no CUDA device; this run needs one GPU")
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    ok = True
    for fault, edit in FAULTS.items():
        res = run(fault, edit)
        print(json.dumps(res), flush=True)
        if (fault == "none") == bool(res["caught_in"]):
            ok = False
            print(f"{fault}: the gate {'failed' if fault == 'none' else 'passed'}"
                  " where it should not", flush=True)
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
