"""Shows that chip_smoke.py's fused-MLP gate rejects broken qmlp kernels, and
runs compute-sanitizer over every instantiation of the kernel.

    python3 scripts/qmlp_gate_mutants.py              # needs one CUDA card
    python3 scripts/qmlp_gate_mutants.py none         # the real kernel only
    python3 scripts/qmlp_gate_mutants.py --sanitize   # compute-sanitizer

For each fault below (and once without one) the script copies
``src/repro_torch`` into a temporary directory, plants the fault in the
copy's ``csrc/qmlp.cu``, and in a fresh process builds that copy's qmlp
kernel and runs every fused-MLP case of chip_smoke.py (``qmlp_cases``:
llama3.2-3b's swiglu at phase 3's M values, zamba2's at 1 and 4,
whisper-medium's gelu at 1, 4 and 1500; int8, int4 and ternary) through
chip_smoke.py's gate: TOL (rtol = atol = 2e-2) against the plain version,
QMLP_F32 against ``fused_mlp_f32`` (the MLP in f32 with h in f32), and a
second call equal to the first to the bit. It prints one JSON line per
fault: the largest and smallest reading of each check over the cases and
the cases each catches. It exits non-zero if the unchanged kernel fails a
case or a faulty one passes every case. The repo itself is never changed.
The run without a fault (``none``) also times each case (chip_smoke.py's
Timer: the L2 flushed before each of 20 calls in a CUDA graph).

Faults:
  drop_part       the sum over the FF parts (512 FF rows each: one
                  cluster's) skips the first part;
  swap_gate_up    the activation takes the up product as the gate and the
                  gate product as up (the gelu form has no gate: unchanged);
  no_activation   h = g * u for swiglu, h = u for gelu;
  last_scale      the last K group of the gate and up products is scaled
                  by the scales of the group before.

``--sanitize`` runs compute-sanitizer's memcheck, racecheck, synccheck and
initcheck tools, one process each, over the real kernel at small shapes
(K 256, FF 1024, D 256) in both forms, three precisions, bf16 and f32 x,
M = 1, 4, 8, 20 and 67 (bf16: a ragged chunk of 32 rows), and at K 3072
with bf16 x, M = 20, where the kernel takes chunks of 16 rows: every
template instantiation. It exits non-zero if a tool reports an error or
cannot run (``"ran": false`` where the tool refuses the device).
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
    "drop_part": [("for (int c = 0; c < parts; ++c)",
                   "for (int c = 1; c < parts; ++c)")],
    "swap_gate_up": [("act<GELU>(gate_v, up_v)", "act<GELU>(up_v, gate_v)")],
    "no_activation": [("return GELU ? gelu_tanh(u) : silu(g) * u;",
                       "return GELU ? u : g * u;")],
    "last_scale": [("issue<PACKED>(slot, sca[u], ra, kg, kg, q);",
                    "issue<PACKED>(slot, sca[u], ra, kg, "
                    "kg == ngk - 1 ? kg - 1 : kg, q);")],
}

# run in the child process, with the copy's src/ first on sys.path: every
# fused-MLP case of chip_smoke.py through its gate, without raising
CHILD = r"""
import json, sys, torch
import chip_smoke as C
from repro_torch.kernels import build
from repro_torch.kernels.qmatmul import ops as QM
from repro_torch.quant.quantize import quantize
assert QM.__file__.startswith(sys.argv[1]), QM.__file__
build.SOURCES = ("qmlp",)
torch.backends.cuda.matmul.allow_tf32 = False
gen = torch.Generator(device="cuda").manual_seed(0)
timer = C.Timer(torch) if sys.argv[2] == "time" else None

def weight(n, k):
    return (torch.randn((n, k), generator=gen, device="cuda")
            / k ** 0.5).to(torch.bfloat16)

def act(m, k):
    return (torch.randn((m, k), generator=gen, device="cuda") * 0.5
            ).to(torch.bfloat16)

def largest(a, b):
    return float((a - b).abs().nan_to_num(float("inf")).max())

cases = []
for form, label, ff, d, ms in C.qmlp_cases():
    for prec in C.MATMUL_PRECISIONS:
        wg = None if form == "gelu" else quantize(weight(ff, d), prec)
        wu, wdn = quantize(weight(ff, d), prec), quantize(weight(d, ff), prec)
        for m in ms:
            x = act(m, d)
            got = QM.qmlp_cuda(x, wg, wu, wdn)
            second = QM.qmlp_cuda(x, wg, wu, wdn)
            want = QM.fused_mlp_plain(x, wg, wu, wdn, act=form).float()
            exact = QM.fused_mlp_f32(x, wg, wu, wdn, act=form)
            torch.cuda.synchronize()
            row = dict(case=f"{label} {prec} M={m}", err=largest(got, want),
                       err_f32=largest(got, exact),
                       bit_identical=bool(torch.equal(got, second)))
            try:
                torch.testing.assert_close(got, want, **C.TOL)
                row["tol"] = "pass"
            except AssertionError:
                row["tol"] = "fail"
            row["f32"] = "pass" if row["err_f32"] <= C.QMLP_F32 else "fail"
            row["caught"] = (row["tol"] == "fail" or row["f32"] == "fail"
                             or not row["bit_identical"])
            if timer is not None:
                row["ms"] = timer.ms(lambda: QM.qmlp_cuda(x, wg, wu, wdn))
            cases.append(row)
            del got, second, want, exact
        del wg, wu, wdn
print(json.dumps(cases))
"""

# run under compute-sanitizer: every instantiation at small shapes
SANITIZE_CHILD = r"""
import torch
from repro_torch.kernels.qmatmul import ops as QM
from repro_torch.quant.quantize import quantize
gen = torch.Generator(device="cuda").manual_seed(0)

def weight(n, k):
    return (torch.randn((n, k), generator=gen, device="cuda")
            / k ** 0.5).to(torch.bfloat16)

# (K, x dtypes, M values): chunks of 8 rows (M <= 8, and f32 x), of 32
# (bf16 M 20 and 67 at K 256), and of 16 (bf16 M 20 at K 3072)
sets = [(256, (torch.bfloat16, torch.float32), (1, 4, 8, 20, 67)),
        (3072, (torch.bfloat16,), (20,))]
ff, d, n = 1024, 256, 0
for k, dtypes, ms in sets:
    for form in ("swiglu", "gelu"):
        for prec in ("int8", "int4", "ternary"):
            wg = None if form == "gelu" else quantize(weight(ff, k), prec)
            wu, wdn = quantize(weight(ff, k), prec), quantize(weight(d, ff),
                                                              prec)
            for dt in dtypes:
                for m in ms:
                    x = (torch.randn((m, k), generator=gen, device="cuda")
                         * 0.5).to(dt)
                    QM.qmlp_cuda(x, wg, wu, wdn)
                    n += 1
torch.cuda.synchronize()
print(f"launches: {n}")
"""


def run(fault: str, edits) -> dict:
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="qmlp_mutant_"))
    try:
        src = tmp / "src" / "repro_torch"
        shutil.copytree(ROOT / "src" / "repro_torch", src,
                        ignore=shutil.ignore_patterns("__pycache__"))
        cu = src / "csrc" / "qmlp.cu"
        text = cu.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{fault}: the text to change is not in "
                                 f"qmlp.cu once: {old!r}")
            text = text.replace(old, new)
        cu.write_text(text)
        env = dict(os.environ,
                   PYTHONPATH=os.pathsep.join([str(tmp / "src"), str(ROOT)]))
        out = subprocess.run([sys.executable, "-c", CHILD, str(tmp),
                              "time" if fault == "none" else "-"],
                             env=env, capture_output=True, text=True,
                             timeout=900)
        if out.returncode:
            raise SystemExit(f"{fault}: the run failed\n{out.stderr[-4000:]}")
        cases = json.loads(out.stdout.strip().splitlines()[-1])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    caught = [c for c in cases if c["caught"]]
    return dict(fault=fault, cases_run=len(cases),
                max_err=max(c["err"] for c in cases),
                max_err_f32=max(c["err_f32"] for c in cases),
                min_err_f32=min(c["err_f32"] for c in cases),
                caught=len(caught),
                caught_by_tol=sum(c["tol"] == "fail" for c in cases),
                caught_by_f32=sum(c["f32"] == "fail" for c in cases),
                not_bit_identical=sum(not c["bit_identical"] for c in cases),
                caught_in=[c["case"] for c in caught], cases=cases)


def sanitize() -> bool:
    tool = shutil.which("compute-sanitizer") or \
        "/usr/local/cuda/bin/compute-sanitizer"
    if not os.path.exists(tool):
        print(json.dumps({"sanitizer": None,
                          "reason": "compute-sanitizer not found"}))
        return False
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    # build once outside the sanitizer, so that it times only the launches
    subprocess.run([sys.executable, "-c", "from repro_torch.kernels import "
                    "build; build.library('qmlp')"], env=env, check=True)
    ok = True
    for name in ("memcheck", "racecheck", "synccheck", "initcheck"):
        cmd = [tool, "--tool", name, "--error-exitcode", "9",
               "--target-processes", "all", sys.executable, "-c",
               SANITIZE_CHILD]
        if name == "racecheck":
            cmd[3:3] = ["--racecheck-report", "all"]
        try:
            out = subprocess.run(cmd, env=env, capture_output=True,
                                 text=True, timeout=600)
        except subprocess.TimeoutExpired:
            print(json.dumps(dict(tool=name, rc=None,
                                  summary=["timed out after 600 s"])))
            ok = False
            continue
        text = out.stdout + out.stderr
        tail = [ln for ln in text.splitlines()
                if "ERROR SUMMARY" in ln or "RACECHECK SUMMARY" in ln
                or "launches:" in ln]
        res = dict(tool=name, rc=out.returncode, summary=tail)
        if "Device not supported" in text:
            # the tool refuses the device: nothing was checked
            res["ran"] = False
            res["reason"] = "compute-sanitizer: Device not supported"
        if out.returncode != 0:
            ok = False
            res["output"] = text[-3000:]
        print(json.dumps(res), flush=True)
    return ok


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("qmlp_gate_mutants: no CUDA device; this run needs one GPU")
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    if sys.argv[1:] == ["--sanitize"]:
        ok = sanitize()
        print(json.dumps({"ok": ok}))
        return 0 if ok else 1
    names = sys.argv[1].split(",") if len(sys.argv) > 1 else list(FAULTS)
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
