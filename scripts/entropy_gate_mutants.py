"""Shows that chip_smoke.py's entropy gates reject broken entropy kernels.

    python3 scripts/entropy_gate_mutants.py      # needs one CUDA card

For each fault below (and once without one) the script copies
``src/repro_torch`` into a temporary directory, plants the fault in the
copy's ``csrc/entropy.cu``, and in a fresh process builds that copy's
kernel and runs it over chip_smoke.py's entropy cases (``entropy_inputs``,
each a launch of one array) and its grouped case (``entropy_group_inputs``
in one launch, ``entropy_group_check``) against the plain version, through
chip_smoke.py's own gate (``entropy_fault``). It prints one JSON line per
fault: the largest error and, per case, what the gate said (and for the
grouped case whether each H equals its single launch and a second grouped
launch). It exits non-zero if the unchanged kernel fails a case or an
equality, or a faulty one passes every case. The repo itself is never
changed.

Faults:
  drop_partial     pass 2 merges all but the last tile partial of an array;
  drop_tail        pass 1 skips the elements past a tile's last 16-byte
                   load;
  drop_sz          pass 2 writes m + log Z, without the - S/Z term;
  merge_neighbour  pass 2 merges the first tile of the next array into an
                   array's partials (only a grouped launch can show it).
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
    "drop_partial": ("const int end = begin + run < hi ? begin + run : hi;",
                     "const int end = begin + run < hi - 1 ? begin + run "
                     ": hi - 1;"),
    "drop_tail": ("tail = nv * kPer;", "tail = cnt;"),
    "drop_sz": ("out[a] = (st.m + logf(st.z)) - st.s / st.z;",
                "out[a] = st.m + logf(st.z);"),
    "merge_neighbour": ("const int hi = tab.first[a + 1];",
                        "const int hi = tab.first[a + 1] + "
                        "(a + 1 < (int)gridDim.x);"),
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
for c in C.entropy_group_check(torch, EN, C.entropy_group_inputs(torch, gen)):
    cases.append(dict(case="grouped " + c["case"], err=c["err"],
                      fault=c["fault"], equal_single=c["equal_single"],
                      equal_twice=c["equal_twice"]))
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
    unequal = [c["case"] for c in cases
               if not (c.get("equal_single", True)
                       and c.get("equal_twice", True))]
    return dict(fault=fault, max_err=max(c["err"] for c in cases),
                caught_in=caught, unequal_in=unequal, cases=cases)


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
        if (fault == "none") == bool(res["caught_in"]) or (
                fault == "none" and res["unequal_in"]):
            ok = False
            print(f"{fault}: the gate {'failed' if fault == 'none' else 'passed'}"
                  " where it should not", flush=True)
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
