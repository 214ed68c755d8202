"""Shows that chip_smoke.py's attention gate rejects broken decode attention
kernels.

    python3 scripts/decode_attn_gate_mutants.py      # needs one CUDA card
    python3 scripts/decode_attn_gate_mutants.py none # the real kernel only

For each fault below (and once without one) the script copies
``src/repro_torch`` into a temporary directory, plants the fault in the
copy's ``csrc/decode_attn.cu``, and in a fresh process builds that copy's
kernels and runs chip_smoke.py's decode attention cases
(``attention_cases``) against the plain version, through chip_smoke.py's
own gate (``attn_fault``: ATTN_REL_L2). It prints one JSON line per fault:
the largest and smallest relative L2 over the cases, the cases the gate
catches, and how many of them the elementwise 2e-2 tolerance alone would
catch. It exits non-zero if the unchanged kernel fails a case or a faulty
one passes every case. The repo itself is never changed.

The run without a fault (``none``) also profiles each int8 case
(``torch.profiler``, 20 calls, each after a write that pushes the L2 out):
``split_us`` and ``merge_us`` are the device microseconds per call of the
split kernel and of the merge kernel.

Faults:
  drop_split   the last split that holds rows of a slot writes the empty
               state (its rows are lost);
  no_rescale   the merge adds the splits' partials without their
               exp(m_j - m) weights;
  overlap      every split after the first starts one row early, so the
               row at each boundary is counted twice (its row lookups get
               room for the extra row);
  swap_tables  a pool's K rows are read through V's page table and V's
               through K's.
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
    "none": [],
    "drop_split": [("if (!fresh && lo >= end) {",
                    "if (!fresh && (lo >= end || (j + 1) * kSplit >= end)) {")],
    "no_rescale": [("? 0.f : expf(ml.x - mx);", "? 0.f : 1.f;")],
    "overlap": [("lo = j * kSplit;", "lo = j > 0 ? j * kSplit - 1 : 0;"),
                # room for the split's one extra row in the row lookups
                ("o.vrow = o.krow + split * 4;",
                 "o.vrow = o.krow + (split + kTile) * 4;"),
                ("o.kshift = o.vrow + split * 4;",
                 "o.kshift = o.vrow + (split + kTile) * 4;"),
                ("o.vshift = o.kshift + split;",
                 "o.vshift = o.kshift + split + kTile;"),
                ("o.total = o.vshift + split;",
                 "o.total = o.vshift + split + kTile;")],
    "swap_tables": [("const int* kt = paged ? ktable",
                     "const int* kt = paged ? vtable"),
                    ("const int* vt = paged ? vtable",
                     "const int* vt = paged ? ktable")],
}

# run in the child process, with the copy's src/ first on sys.path
CHILD = r"""
import json, sys, torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as C
from repro_torch.kernels.decode_attn import ops as DA
from repro_torch.quant import paged as PG
assert DA.__file__.startswith(sys.argv[1]), DA.__file__
flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")

def kernel_us(call):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            flush.zero_()
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if "decode_attn_" in e.key:
            tot = getattr(e, "device_time_total", None)
            if tot is None:
                tot = e.cuda_time_total
            out["split_us" if "split" in e.key else "merge_us"] = tot / e.count
    return out

cases = []
for c in C.attention_cases(torch):
    got, want, fq = C.attn_outputs(torch, c)
    row = dict(case=f"{c['kernel']} {c['shape']} {c['kp'].precision}",
               rel_l2=C.attn_rel_l2(got, want),
               max_abs=float((got - want).abs().nan_to_num(float("inf")).max()),
               fault=C.attn_fault(got, want))
    try:
        torch.testing.assert_close(got, want, **C.TOL)
        row["tol_2e-2"] = "pass"
    except AssertionError:
        row["tol_2e-2"] = "fail"
    if hasattr(c["kp"], "table"):
        dense = DA.decode_attn_cuda(c["q"], PG.gather(c["kp"]),
                                    PG.gather(c["vp"]), c["valid"],
                                    c["causal"], fq).float()
        row["equal_to_dense_kernel"] = bool(torch.equal(got, dense))
    if sys.argv[2] == "profile" and c["kp"].precision == "int8":
        row.update(kernel_us(lambda: DA.decode_attn_cuda(
            c["q"], c["kp"], c["vp"], c["valid"], c["causal"], fq)))
    cases.append(row)
    del c, got, want, fq
print(json.dumps(cases))
"""


def run(fault: str, edits) -> dict:
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="decode_attn_mutant_"))
    try:
        src = tmp / "src" / "repro_torch"
        shutil.copytree(ROOT / "src" / "repro_torch", src,
                        ignore=shutil.ignore_patterns("__pycache__"))
        cu = src / "csrc" / "decode_attn.cu"
        text = cu.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{fault}: the text to change is not in "
                                 f"decode_attn.cu once: {old!r}")
            text = text.replace(old, new)
        cu.write_text(text)
        env = dict(os.environ,
                   PYTHONPATH=os.pathsep.join([str(tmp / "src"), str(ROOT)]))
        out = subprocess.run([sys.executable, "-c", CHILD, str(tmp),
                              "profile" if fault == "none" else "-"],
                             env=env, capture_output=True, text=True,
                             timeout=900)
        if out.returncode:
            raise SystemExit(f"{fault}: the run failed\n{out.stderr[-4000:]}")
        cases = json.loads(out.stdout.strip().splitlines()[-1])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    caught = [c for c in cases if c["fault"]]
    return dict(fault=fault, cases_run=len(cases),
                max_rel_l2=max(c["rel_l2"] for c in cases),
                min_rel_l2=min(c["rel_l2"] for c in cases),
                max_abs=max(c["max_abs"] for c in cases),
                caught=len(caught),
                caught_by_tol_alone=sum(c["tol_2e-2"] == "fail"
                                        for c in cases),
                paged_unequal_to_dense=sum(
                    not c.get("equal_to_dense_kernel", True) for c in cases),
                caught_in=[c["case"] for c in caught], cases=cases)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("decode_attn_gate_mutants: no CUDA device; this run needs one "
              "GPU")
        return 2
    names = sys.argv[1].split(",") if len(sys.argv) > 1 else list(FAULTS)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    ok = True
    for fault in names:
        res = run(fault, FAULTS[fault])
        print(json.dumps(res), flush=True)
        if (fault == "none") == bool(res["caught"]):
            ok = False
            print(f"{fault}: the gate {'failed' if fault == 'none' else 'passed'}"
                  " where it should not", flush=True)
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
