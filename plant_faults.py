#!/usr/bin/env python3
"""Plant known faults in K3p and show that ``chip_smoke.py``'s K2p/K3p
check fails on each of them.

For the unchanged source and for each fault in FAULTS, the script copies the
port's package, ``chip_smoke.py`` and the pulse-grid model into a temporary
directory, makes the fault's one text replacement in the copy's
``csrc/mnle_pulse.cu``, and runs ``chip_smoke.phase_k2pk3p`` there (the
copy builds its own kernels) at 1,200 and at 115,200 rows, each size on its
own. It prints the check's lines for each run, then one JSON object as the
last line: per fault and size, "passed" or "failed". It exits with 0 only if
the unchanged source passes at both sizes and every fault fails at both.

Run from the root of a checkout on a machine with one CUDA card and nvcc:
``python3 plant_faults.py``. The checkout itself is never changed.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "sbi_for_diffusion_models_tpu_torch"
KERNEL = f"{PKG}/csrc/mnle_pulse.cu"
MODEL = "artifacts/models/mnle_1m_pulseabs.npz"

# name -> (text in csrc/mnle_pulse.cu, its replacement), each in K3p only.
FAULTS = {
    "none": None,
    # d emb loses the slot head's term (the product with the transposed slot weights).
    "no_slot_head_backward": (
        "  dense(slot, p.NS, p.NS, p.slot_wt, H, nullptr, gbuf[0], H, H, false, emb, HF, true);\n", ""),
    # d kf is written as zeros.
    "zero_dkf": ("dkf[(size_t)(row0 + rr) * p.F + f] = dkf_s[idx];", "dkf[(size_t)(row0 + rr) * p.F + f] = 0.0f;"),
    # The last bin's right derivative takes its gradient as d_{K-1}, not the shared d_K = d_0.
    "wrap_derivative_not_shared": ("const int k1 = (k + 1) % K;", "const int k1 = k + 1 < K ? k + 1 : k;"),
}

CHILD = """
import json, torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
out = {}
for n in (cs.ROWS_MAIN, cs.ROWS_SBC):
    try:
        cs.phase_k2pk3p(torch.device("cuda", 0), sizes=(n,))
        out[n] = "passed"
    except AssertionError as e:
        print("[check failed]", e, flush=True)
        out[n] = "failed"
print(json.dumps(out))
"""


def _copy_with_fault(dst: Path, fault) -> None:
    shutil.copytree(ROOT / PKG, dst / PKG, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy2(ROOT / "chip_smoke.py", dst / "chip_smoke.py")
    (dst / MODEL).parent.mkdir(parents=True)
    shutil.copy2(ROOT / MODEL, dst / MODEL)
    if fault is not None:
        old, new = fault
        src = (dst / KERNEL).read_text()
        if src.count(old) != 1:
            raise RuntimeError(f"fault text found {src.count(old)} times in {KERNEL}, expected once: {old!r}")
        (dst / KERNEL).write_text(src.replace(old, new))


def main() -> int:
    results = {}
    for name, fault in FAULTS.items():
        with tempfile.TemporaryDirectory() as tmp:
            _copy_with_fault(Path(tmp), fault)
            proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tmp, capture_output=True, text=True,
                                  timeout=900)
        print(f"== {name} (rc {proc.returncode})", flush=True)
        print(proc.stdout.rstrip(), flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr, flush=True)
            results[name] = {"error": f"rc {proc.returncode}"}
            continue
        results[name] = json.loads(proc.stdout.strip().splitlines()[-1])
    ok = all(
        isinstance(r, dict) and "error" not in r
        and all(v == ("passed" if name == "none" else "failed") for v in r.values())
        for name, r in results.items()
    )
    print(json.dumps({"ok": ok, "results": results}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
