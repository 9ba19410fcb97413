"""The K1 fixture: outputs of the parent K1 (``csrc/ddm_rt_choice.cu`` as it
stood before its H100 redesign) on inputs any machine rebuilds from seeds.

K1 draws a trial's noise from Philox keyed by the seed, with counter (step
group, trial index), so a trial's output depends only on (theta, stimulus,
seed, trial index), not on which lane, group or block simulates it, nor on
N. A redesign of K1 that keeps that stream, the step's rounding and the
window's rules must return these outputs bit for bit; the parent's stream
cannot be reproduced on the CPU, hence a fixture made on the card.

Inputs: theta uniform in the box of the prior's central 99 % intervals
(``THETA_BOX``), t_nd scaled into the window; the stimulus +-1 with
probability 1/2. theta and the stimulus each come from a numpy generator of
their own (``inputs``), so the first n rows are the same for any N >= n.

``data/k1_parent_outputs.npz`` holds, per case of ``CASES``, the (N, 2)
output, and beside them the parent commit. Rewrite it on a machine with a
CUDA card and nvcc from a checkout of the parent commit:
``python tests/k1_fixture.py --parent DIR --commit SHA`` (DIR holds that
checkout, e.g. ``git archive SHA | tar -x -C DIR``).

Numpy only at import time.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

PATH = Path(__file__).resolve().parent / "data" / "k1_parent_outputs.npz"

# Beta(2,2) a0, LogNormal(-1,1) lam, LogNormal(0,1) v, LogNormal(2.75,0.5) B, Beta(2,2) t_nd: each marginal's
# 0.5 % and 99.5 % quantiles (pipeline.build_prior_theta), rounded outwards.
THETA_BOX = np.array([[0.041, 0.959], [0.0279, 4.84], [0.076, 13.15], [4.31, 56.71], [0.041, 0.959]])

KW = dict(dt=5e-4, t_max=0.8, steps_per_pulse=200, n_max=1600)  # tests/test_torch_cuda.py's window: 8 chunks
FULL = dict(dt=5e-4, t_max=8.0, steps_per_pulse=200, n_max=16000)  # the main path's window: 80 chunks
COLLAPSE = 2.0  # 1/s: by the window's end at 0.8 s the bounds close to 0.6 B and 0.4 B


def _case(name, n, window, collapse, seed):
    return name, dict(n=n, window=window, collapse_rate=collapse, seed=seed)


# name -> (N, window, collapse_rate, seed): the seed makes the inputs and is the seed K1 is called with.
CASES = dict(
    [_case(f"kw_n{n}_c{int(c)}", n, "kw", c, 100 + i) for i, (n, c) in enumerate(
        (n, c) for c in (0.0, COLLAPSE) for n in (1, 31, 33, 4096, 8192))]
    + [_case("full_n4096", 4096, "full", 0.0, 200),
       # More trials than the H100 holds lanes of K1 at once (132 SMs x 16 blocks x 128): groups refill.
       _case("kw_n300000_c0", 300_000, "kw", 0.0, 300)]
)
WINDOWS = {"kw": KW, "full": FULL}


def inputs(n: int, window: str, seed: int):
    """(theta (n, 5), stimulus (n, P)) float32 numpy arrays for a case; the
    first rows are the same for any larger n."""
    w = WINDOWS[window]
    P = w["n_max"] // w["steps_per_pulse"]
    lo, hi = THETA_BOX[:, 0], THETA_BOX[:, 1]
    theta = np.random.default_rng([seed, 0]).uniform(lo, hi, size=(n, 5))
    theta[:, 4] *= 0.3 * w["t_max"]  # onsets inside the first 30 % of the window
    s = np.where(np.random.default_rng([seed, 1]).random((n, P)) < 0.5, 1.0, -1.0)
    return theta.astype(np.float32), s.astype(np.float32)


def kwargs(case: dict) -> dict:
    """The keyword arguments of ``ddm_rt_choice_cuda`` for a case."""
    return dict(mu_sensory=1.0, collapse_rate=case["collapse_rate"], **WINDOWS[case["window"]])


def load(path: Path = PATH) -> dict:
    """name -> (N, 2) float32 outputs, plus ``"parent_commit"``."""
    with np.load(path) as data:
        out = {name: data[name] for name in CASES}
        out["parent_commit"] = str(data["parent_commit"])
    return out


def run(ddm_rt_choice_cuda, case: dict, device, n: int | None = None):
    """K1 (the given wrapper) on a case's inputs, extended to ``n`` rows."""
    import torch

    theta, s = inputs(n or case["n"], case["window"], case["seed"])
    th, st = (torch.from_numpy(a).to(device) for a in (theta, s))
    return ddm_rt_choice_cuda(th, st, case["seed"], **kwargs(case))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="write the K1 fixture with the K1 of a parent checkout")
    ap.add_argument("--parent", type=Path, required=True, help="checkout of the parent commit")
    ap.add_argument("--commit", required=True, help="the parent commit's hash, stored beside the outputs")
    ap.add_argument("--out", type=Path, default=PATH)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.parent.resolve()))
    import torch

    from sbi_for_diffusion_models_tpu_torch.ops.ddm_cuda import ddm_rt_choice_cuda

    if not ddm_rt_choice_cuda.__code__.co_filename.startswith(str(args.parent.resolve())):
        raise RuntimeError(f"the port was imported from {ddm_rt_choice_cuda.__code__.co_filename}, not the parent")
    device = torch.device("cuda", 0)
    outs = {}
    for name, case in CASES.items():
        outs[name] = run(ddm_rt_choice_cuda, case, device).cpu().numpy()
        again = run(ddm_rt_choice_cuda, case, device).cpu().numpy()
        if not np.array_equal(outs[name], again):
            raise RuntimeError(f"{name}: two launches of the parent K1 differ")
        print(f"[k1 fixture] {name}: choices {np.bincount(outs[name][:, 1].astype(int), minlength=3).tolist()}")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, parent_commit=np.array(args.commit), **outs)
    print(f"[k1 fixture] wrote {args.out} ({args.out.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
