#!/usr/bin/env python3
"""Plant known faults in the fused MNLE kernels (K2/K3, K2p/K3p) and the
simulator K1, and show that ``chip_smoke.py``'s kernel checks fail on each
of them.

For the unchanged source and for each fault in FAULTS, the script copies the
port's package, ``chip_smoke.py`` and the committed models into a temporary
directory, makes the fault's one text replacement in the copy of the
fault's kernel file, and runs the fault's check there (the copy builds its
own kernels): ``chip_smoke.phase_k2k3`` for K2/K3 (``csrc/mnle_logprob.cu``,
with the tile product of ``csrc/mnle_tile.cuh``), ``chip_smoke.phase_k2pk3p``
for K2p/K3p (``csrc/mnle_pulse.cu``), at 1,200 and at 115,200 rows, each
size on its own; ``chip_smoke.phase_k1_fixture`` for K1
(``csrc/ddm_rt_choice.cu``: every case of the parent K1's committed
outputs, bit for bit), ``chip_smoke.phase_k1_sigma`` for its per-trial
noise scale (each trial's rows at its own sigma) and
``chip_smoke.phase_k1_offset`` for its trial offset, the multi-device
phase's K1 check (a batch launched in blocks, each from its offset, against
one launch). The copy's kernels are built before any check runs: a planted
source that does not build or load fails this script, not the check. A check
that raises an AssertionError, or the CUDA error of a kernel that faults or
fails to launch, counts as failed; any other error fails this script. The
unchanged source runs every check. It prints the checks' lines for each run, then one JSON object
as the last line: per fault and size, "passed" or "failed". It exits with 0
only if the unchanged source passes every check at both sizes and every
fault fails at both.

Run from the root of a checkout on a machine with one CUDA card and nvcc:
``python3 plant_faults.py [FAULT ...]``: with names, only those faults,
and the unchanged source runs only their checks. The checkout itself is
never changed.
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
DATA = ("artifacts/models/mnle_10m_shifted_logt_affine.npz", "artifacts/models/mnle_1m_pulseabs.npz",
        "tests/k1_fixture.py", "tests/data/k1_parent_outputs.npz")
K3_FILE, K3P_FILE, TILE_FILE, K1_FILE = "mnle_logprob.cu", "mnle_pulse.cu", "mnle_tile.cuh", "ddm_rt_choice.cu"

# name -> (file in csrc/, the check's phase, text in the file, its replacement), or None for the unchanged
# source, which runs every phase.
FAULTS = {
    "none": None,
    # K3: the knots are an exclusive scan of the widths, each lane's knot one lane early.
    "k3_knot_scan_shifted": (K3_FILE, "phase_k2k3", "const double cw = warp_inclusive_scan(wd, lane);",
                             "const double cw = warp_inclusive_scan(wd, lane) - wd;"),
    # K3: the ballot picks the last bin whose upper knot exceeds z, not the first.
    "k3_ballot_last_bin": (K3_FILE, "phase_k2k3", "b.k = below != 0u ? __ffs(below) - 1 : K - 1;",
                           "b.k = below != 0u ? 31 - __clz(below) : K - 1;"),
    # K3's tile product leaves out the ragged last chunk of k (in_w not a multiple of 32).
    "k3_tile_drops_ragged_k": (TILE_FILE, "phase_k2k3", "return k0 + TILE_KC >= in_w;",
                               "return k0 + 2 * TILE_KC > in_w;"),
    # K3: the value it writes beside its gradients leaves out the categorical term.
    "k3_value_skips_categorical": (K3_FILE, "phase_k2k3", "if (lane == 0) out[row] = lp;",
                                   "if (lane == 0) out[row] = lp - cat_logprob_strided(logits + r, ohr, R, p.C);"),
    # K2 (and K3, one warp_find_bin): the ballot's bin is one above the first whose upper knot exceeds z.
    "k2_ballot_off_by_one": (K3_FILE, "phase_k2k3", "b.k = below != 0u ? __ffs(below) - 1 : K - 1;",
                             "b.k = below != 0u ? __ffs(below) : K - 1;"),
    # K2p (and K3p, one product list): the padded head is read with the unpadded leading dimension HO, not head_ld.
    "k2p_head_unpadded_ld": (K3P_FILE, "phase_k2pk3p", "case 1: return {p.head_w, p.head_b, p.head_ld, H + p.F,",
                             "case 1: return {p.head_w, p.head_b, p.HO, H + p.F,"),
    # K2p (and K3p's value): the slot head's log-softmax picks the logit of the next slot.
    "k2p_slot_logit_off_by_one": (K3P_FILE, "phase_k2pk3p", "return sl[ki * ld] - mx - logf(s.slot_sum);",
                                  "return sl[min(ki + 1, NS - 1) * ld] - mx - logf(s.slot_sum);"),
    # K3p: d emb loses the slot head's term (the slot logits' gradient is zeroed, as for a slot outside the head).
    "no_slot_head_backward": (K3P_FILE, "phase_k2pk3p", "warp_slot_grad(slot + r, R, p.NS, kv[row], gm, s, lane);",
                              "warp_slot_grad(slot + r, R, p.NS, -1.0f, gm, s, lane);"),
    # K3p: d kf is written as zeros.
    "zero_dkf": (K3P_FILE, "phase_k2pk3p", "dkf[(size_t)(row0 + r) * p.F + f] = dkf_s[f * R + r];",
                 "dkf[(size_t)(row0 + r) * p.F + f] = 0.0f;"),
    # K3p: the last bin's right derivative takes its gradient as d_{K-1}, not the shared d_K = d_0.
    "wrap_derivative_not_shared": (K3P_FILE, "phase_k2pk3p", "(lane == (k + 1) % K ? g_dk1 : 0.0f)",
                                   "(lane == min(k + 1, K - 1) ? g_dk1 : 0.0f)"),
    # K2p and K3p (one circular_phase): the phase's mod is C's fmodf, negative below 0, instead of the floor-mod.
    "k3p_fmodf_phase": (K3P_FILE, "phase_k2pk3p", "*m = a - floorf(a);", "*m = fmodf(a, 1.0f);"),
    # K1: a group's step takes its noise from the next lane of the group (the same distribution: only the parent's
    # bits catch it).
    "k1_noise_from_the_wrong_lane": (K1_FILE, "phase_k1_fixture", "e[k & 3], leader + (k >> 2))",
                                     "e[k & 3], leader + (((k >> 2) + 1) & (G - 1)))"),
    # K1: the refill skips one trial index (the first it would hand out), which is never simulated.
    "k1_refill_skips_a_trial": (K1_FILE, "phase_k1_fixture", "trial = groups + base + ",
                                "trial = groups + 1u + base + "),
    # K1: the chunk's kick lands on its second step.
    "k1_kick_on_the_second_step": (K1_FILE, "phase_k1_fixture", "const int koff = tr.chunk * steps_per_pulse - t;",
                                   "const int koff = tr.chunk * steps_per_pulse + 1 - t;"),
    # K1's per-trial noise scale: a group's first trial takes the next trial's sigma.
    "k1_sigma_of_the_next_trial": (K1_FILE, "phase_k1_sigma",
                                   "float sig = SIG_ROWS ? __fmul_rn(mu_rows[j], sig_sqrt_dt)",
                                   "float sig = SIG_ROWS ? __fmul_rn(mu_rows[(j + 1) % N], sig_sqrt_dt)"),
    # K1's per-trial noise scale: a refilled group keeps its previous trial's sigma.
    "k1_sigma_kept_on_refill": (K1_FILE, "phase_k1_sigma", "if (SIG_ROWS) sig = __fmul_rn(mu_rows[j], sig_sqrt_dt);",
                                "if (SIG_ROWS) sig = sig;"),
    # K1's trial offset: Philox's counter takes the local trial index (a block repeats the first block's noise).
    "k1_counter_ignores_the_offset": (K1_FILE, "phase_k1_offset",
                                      'asm("add.u32 %0, %1, %2;" : "=r"(r) : "r"(trial_offset), "r"(j));',
                                      'asm("mov.u32 %0, %1;" : "=r"(r) : "r"(j));'),
    # K1's trial offset: the output is written at the global index as well (past the block's own rows).
    "k1_output_at_the_global_index": (K1_FILE, "phase_k1_offset", "out[trial] = make_float2(",
                                      "out[noise_trial(trial, trial_offset)] = make_float2("),
}
PHASES = ("phase_k2k3", "phase_k2pk3p", "phase_k1_fixture", "phase_k1_sigma", "phase_k1_offset")

# The source each check's kernels are built from.
PHASE_SOURCES = {"phase_k2k3": K3_FILE, "phase_k2pk3p": K3P_FILE, "phase_k1_fixture": K1_FILE,
                 "phase_k1_sigma": K1_FILE, "phase_k1_offset": K1_FILE}

# argv: the sources to build (comma-separated), then the checks.
CHILD = """
import json, sys, torch
import chip_smoke as cs
from sbi_for_diffusion_models_tpu_torch.ops import _cuda, ddm_cuda, mnle_cuda  # noqa: F401 (their kernels)
torch.backends.cuda.matmul.allow_tf32 = False
for lib in _cuda._LIBRARIES.values():  # a build or load error ends this process: it is no check's verdict
    if lib.source.name in sys.argv[1].split(","):
        lib.load()
fault_errors = (AssertionError, getattr(torch, "AcceleratorError", AssertionError))
out = {}
for phase in sys.argv[2:]:
    for n in ((None,) if phase.startswith("phase_k1") else (cs.ROWS_MAIN, cs.ROWS_SBC)):
        try:
            getattr(cs, phase)(torch.device("cuda", 0), **({} if n is None else {"sizes": (n,)}))
            out[phase if n is None else f"{phase}@{n}"] = "passed"
        except Exception as e:  # a planted fault may also make the kernel fault or fail to launch
            if not (isinstance(e, fault_errors) or "kernel launch failed" in str(e) or "CUDA error" in str(e)):
                raise
            print("[check failed]", type(e).__name__, e, flush=True)
            out[phase if n is None else f"{phase}@{n}"] = "failed"
print(json.dumps(out))
"""


def _copy_with_fault(dst: Path, fault) -> None:
    shutil.copytree(ROOT / PKG, dst / PKG, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy2(ROOT / "chip_smoke.py", dst / "chip_smoke.py")
    for data in DATA:
        (dst / data).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(ROOT / data, dst / data)
    if fault is not None:
        name, _, old, new = fault
        path = dst / PKG / "csrc" / name
        src = path.read_text()
        if src.count(old) != 1:
            raise RuntimeError(f"fault text found {src.count(old)} times in {name}, expected once: {old!r}")
        path.write_text(src.replace(old, new))


def main(names: list) -> int:
    import torch

    if not torch.cuda.is_available():
        print("plant_faults: no CUDA device; the checks run only on a GPU", file=sys.stderr)
        return 2
    unknown = set(names) - set(FAULTS)
    if unknown:
        print(f"plant_faults: no such fault: {sorted(unknown)}", file=sys.stderr)
        return 2
    chosen = {name: FAULTS[name] for name in FAULTS if not names or name in names or name == "none"}
    results = {}
    for name, fault in chosen.items():
        with tempfile.TemporaryDirectory() as tmp:
            _copy_with_fault(Path(tmp), fault)
            if fault is not None:
                phases = (fault[1],)
            else:  # the unchanged source runs every check, or those of the chosen faults
                phases = PHASES if not names else tuple(p for p in PHASES if any(FAULTS[k][1] == p for k in names
                                                                                 if FAULTS[k] is not None))
            sources = ",".join(sorted({PHASE_SOURCES[p] for p in phases}))
            proc = subprocess.run([sys.executable, "-c", CHILD, sources, *phases], cwd=tmp, capture_output=True,
                                  text=True, timeout=900)
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
    sys.exit(main(sys.argv[1:]))
