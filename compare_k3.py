#!/usr/bin/env python3
"""Time a fused MNLE backward kernel, K3 or K3p, of two checkouts in turns on
one CUDA card: the "before" and the "after" of a change to it.

The rows are made once, by this checkout (``chip_smoke.session_rows`` on the
kernel's committed model, at 1,200 and 115,200 rows, with a cotangent): the
flagship for K3, the pulse-grid model ``mnle_1m_pulseabs.npz`` for K3p. They
are saved to a temporary file. Each checkout then runs in a process of its
own (both hold a package of one name) from its own root: it loads the model
through its own ``load_model``, calls its own wrapper
(``ops.mnle_cuda.rows_logp_vjp`` for K3, ``rows_logp_pulse_vjp`` for K3p)
once (which builds its kernels in its own ``build/``) and times it with CUDA
events. The order is parent, this, this, parent, and each side's time is the
mean of its two turns. The two sides' gradients (dt and dctx; dphi, dctx and
dkf) are compared: the largest difference of each, and the row it is on.

Run from the root of a checkout, on a machine with one CUDA card and nvcc:
``python3 compare_k3.py --parent DIR [--kernel k3p]``, where DIR holds a
checkout of the earlier commit (``git archive <commit> | tar -x -C DIR``).
The last line is one JSON object; the script exits with 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SIZES = (1_200, 115_200)
REPS = {1_200: 50, 115_200: 10}
# kernel -> (its wrapper in ops.mnle_cuda, the names of its gradients); the model is chip_smoke's for that kernel.
KERNELS = {"k3": ("rows_logp_vjp", ("dt", "dctx")), "k3p": ("rows_logp_pulse_vjp", ("dphi", "dctx", "dkf"))}

CHILD = """
import json, sys, torch
from sbi_for_diffusion_models_tpu_torch.mnle import load_model
from sbi_for_diffusion_models_tpu_torch.ops import mnle_cuda as mc
dev = torch.device("cuda", 0)
data = torch.load(sys.argv[1])
w = mc.pack_mnle_weights(load_model(data["model"], device=dev))
vjp = getattr(mc, data["wrapper"])
grads, ms = {}, {}
for n, (rows, reps) in data["rows"].items():
    *rows, g = (a.to(dev) for a in rows)
    grads[n] = [a.cpu() for a in vjp(*rows, w, g)]
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        vjp(*rows, w, g)
    end.record()
    torch.cuda.synchronize()
    ms[n] = start.elapsed_time(end) / reps
torch.save(grads, sys.argv[2])
print(json.dumps(ms))
"""


def _rows(path: Path, device, kernel: str) -> None:
    """The session rows of the kernel's model at every size of SIZES, saved
    for the children with the model's file name and the wrapper's name."""
    import torch

    import chip_smoke as cs
    from sbi_for_diffusion_models_tpu_torch.mnle import load_model
    from sbi_for_diffusion_models_tpu_torch.pipeline import build_prior_theta

    model = cs.PULSE_MODEL_FILE if kernel == "k3p" else cs.MODEL_FILE
    os.environ["MODEL_DIR"] = str(cs.MODEL_DIR)
    est = load_model(model, device=device)
    rows = cs.session_rows(est, build_prior_theta(), device, -(-max(SIZES) // cs.ROWS_MAIN))
    out = {}
    for n in SIZES:
        g = torch.randn((n,), generator=torch.Generator(device).manual_seed(5), device=device)
        out[n] = ([a[:n].contiguous().cpu() for a in rows] + [g.cpu()], REPS[n])
    torch.save({"model": model, "wrapper": KERNELS[kernel][0], "rows": out}, path)


def _run_side(root: Path, rows: Path, grads: Path) -> dict:
    env = {**os.environ, "MODEL_DIR": str(root / "artifacts" / "models")}
    proc = subprocess.run([sys.executable, "-c", CHILD, str(rows), str(grads)], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"the kernel of {root} failed (rc {proc.returncode}):\n{proc.stdout}\n{proc.stderr[-4000:]}")
    return {int(n): ms for n, ms in json.loads(proc.stdout.strip().splitlines()[-1]).items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True, help="checkout of the commit whose kernel is the 'before'")
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="k3", help="K3 (flagship) or K3p (pulse-grid model)")
    args = ap.parse_args(argv)
    label = {"k3": "K3", "k3p": "K3p"}[args.kernel]
    names = KERNELS[args.kernel][1]

    import torch

    if not torch.cuda.is_available():
        print("compare_k3: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi} torch={torch.__version__} cuda={torch.version.cuda}", flush=True)
    sides = {"parent": args.parent.resolve(), "this": ROOT}
    with tempfile.TemporaryDirectory() as tmp:
        rows = Path(tmp) / "rows.pt"
        _rows(rows, torch.device("cuda", 0), args.kernel)
        ms = {name: {n: [] for n in SIZES} for name in sides}
        for turn, name in enumerate(("parent", "this", "this", "parent")):
            got = _run_side(sides[name], rows, Path(tmp) / f"{name}{turn}.pt")
            for n in SIZES:
                ms[name][n].append(got[n])
            print(f"[time] turn {turn} {name}: " + ", ".join(f"n={n} {got[n]:.4f} ms" for n in SIZES), flush=True)
        grads = {name: torch.load(Path(tmp) / f"{name}{turn}.pt") for turn, name in ((0, "parent"), (1, "this"))}
    report = {"device": smi, "kernel": label, "ms": {}, "speedup": {}, "max_abs_diff": {}}
    for n in SIZES:
        mean = {name: sum(ms[name][n]) / len(ms[name][n]) for name in sides}
        report["ms"][str(n)] = {name: {"turns": ms[name][n], "mean": mean[name]} for name in sides}
        report["speedup"][str(n)] = mean["parent"] / mean["this"]
        diff = {}
        for what, a, b in zip(names, grads["parent"][n], grads["this"][n]):
            d = (a - b).abs().reshape(n, -1).amax(1)
            diff[what] = {"max": float(d.max()), "row": int(d.argmax())}
        report["max_abs_diff"][str(n)] = diff
        print(f"[{label}] n={n}: parent {mean['parent']:.4f} ms, this {mean['this']:.4f} ms, "
              f"{report['speedup'][str(n)]:.3f}x; max |diff| {report['max_abs_diff'][str(n)]}", flush=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
