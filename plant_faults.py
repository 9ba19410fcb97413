#!/usr/bin/env python3
"""Plant known faults in the fused MNLE kernels (K2/K3, K2p/K3p) and the
simulator K1, and show that the card tests that hold those kernels fail on
each of them.

For the unchanged source and for each fault in FAULTS, the script copies the
port's package, ``tests/test_torch_cuda.py`` with what it reads (the K1
fixture, ``tests/card_common.py``'s session rows and row rule, the committed
models) and ``pyproject.toml`` into a temporary directory, makes the fault's
one text replacement in the copy of the fault's kernel file, builds the
copy's kernel library (a planted source that does not build or load fails
this script, not the check), and runs pytest there on the fault's check, a
``-k`` selection of ``tests/test_torch_cuda.py`` (CHECKS):

- K2/K3 (``csrc/mnle_logprob.cu``, with the tile product of
  ``csrc/mnle_tile.cuh``): ``test_k2_k3_match_their_plain_versions`` on the
  committed flagship at 1,200 and at 115,200 session rows, each a case;
- K2p/K3p (``csrc/mnle_pulse.cu``): ``test_k2p_k3p_match_their_plain_versions``
  on the committed pulse-grid model at the same two sizes;
- K1 (``csrc/ddm_rt_choice.cu``): ``test_k1_equals_the_parent_k1_bit_for_bit``
  (every case of the parent K1's committed outputs), ``test_k1_per_trial_noise_scale``
  (each trial's rows at its own sigma) and, for its trial offset,
  ``test_k1_blocks_with_their_offsets_equal_one_launch`` and
  ``test_k1_at_offset_zero_gives_the_parent_bits``.

A case fails by an AssertionError, or by the CUDA error of a kernel that
faults or fails to launch; any other error or a skipped case fails this
script. It prints each run's cases, then one JSON object as the last line:
per fault, each case "passed" or "failed". It exits with 0 only if the
unchanged source passes every case, each K2/K3 and K2p/K3p fault fails its
cases at both sizes, and each K1 fault fails at least one of its check's
cases.

Run from the root of a checkout on a machine with one CUDA card and nvcc:
``python3 plant_faults.py [FAULT ...]``: with names, only those faults, and
the unchanged source runs only their checks. The checkout itself is never
changed.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import xml.etree.ElementTree as ET
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "sbi_for_diffusion_models_tpu_torch"
COPIED = ("pyproject.toml", "tests/test_torch_cuda.py", "tests/k1_fixture.py", "tests/card_common.py",
          "tests/data/k1_parent_outputs.npz", "artifacts/models/mnle_10m_shifted_logt_affine.npz",
          "artifacts/models/mnle_1m_pulseabs.npz")
K3_FILE, K3P_FILE, TILE_FILE, K1_FILE = "mnle_logprob.cu", "mnle_pulse.cu", "mnle_tile.cuh", "ddm_rt_choice.cu"

# name -> (file in csrc/, the check (CHECKS), text in the file, its replacement), or None for the unchanged
# source, which runs every check.
FAULTS = {
    "none": None,
    # K3: the knots are an exclusive scan of the widths, each lane's knot one lane early.
    "k3_knot_scan_shifted": (K3_FILE, "k2k3", "const double cw = warp_inclusive_scan(wd, lane);",
                             "const double cw = warp_inclusive_scan(wd, lane) - wd;"),
    # K3: the ballot picks the last bin whose upper knot exceeds z, not the first.
    "k3_ballot_last_bin": (K3_FILE, "k2k3", "b.k = below != 0u ? __ffs(below) - 1 : K - 1;",
                           "b.k = below != 0u ? 31 - __clz(below) : K - 1;"),
    # K3's tile product leaves out the ragged last chunk of k (in_w not a multiple of 32).
    "k3_tile_drops_ragged_k": (TILE_FILE, "k2k3", "return k0 + TILE_KC >= in_w;",
                               "return k0 + 2 * TILE_KC > in_w;"),
    # K3: the value it writes beside its gradients leaves out the categorical term.
    "k3_value_skips_categorical": (K3_FILE, "k2k3", "if (lane == 0) out[row] = lp;",
                                   "if (lane == 0) out[row] = lp - cat_logprob_strided(logits + r, ohr, R, p.C);"),
    # K2 (and K3, one warp_find_bin): the ballot's bin is one above the first whose upper knot exceeds z.
    "k2_ballot_off_by_one": (K3_FILE, "k2k3", "b.k = below != 0u ? __ffs(below) - 1 : K - 1;",
                             "b.k = below != 0u ? __ffs(below) : K - 1;"),
    # K2p (and K3p, one product list): the padded head is read with the unpadded leading dimension HO, not head_ld.
    "k2p_head_unpadded_ld": (K3P_FILE, "k2pk3p", "case 1: return {p.head_w, p.head_b, p.head_ld, H + p.F,",
                             "case 1: return {p.head_w, p.head_b, p.HO, H + p.F,"),
    # K2p (and K3p's value): the slot head's log-softmax picks the logit of the next slot.
    "k2p_slot_logit_off_by_one": (K3P_FILE, "k2pk3p", "return sl[ki * ld] - mx - logf(s.slot_sum);",
                                  "return sl[min(ki + 1, NS - 1) * ld] - mx - logf(s.slot_sum);"),
    # K3p: d emb loses the slot head's term (the slot logits' gradient is zeroed, as for a slot outside the head).
    "no_slot_head_backward": (K3P_FILE, "k2pk3p", "warp_slot_grad(slot + r, R, p.NS, kv[row], gm, s, lane);",
                              "warp_slot_grad(slot + r, R, p.NS, -1.0f, gm, s, lane);"),
    # K3p: d kf is written as zeros.
    "zero_dkf": (K3P_FILE, "k2pk3p", "dkf[(size_t)(row0 + r) * p.F + f] = dkf_s[f * R + r];",
                 "dkf[(size_t)(row0 + r) * p.F + f] = 0.0f;"),
    # K3p: the last bin's right derivative takes its gradient as d_{K-1}, not the shared d_K = d_0.
    "wrap_derivative_not_shared": (K3P_FILE, "k2pk3p", "(lane == (k + 1) % K ? g_dk1 : 0.0f)",
                                   "(lane == min(k + 1, K - 1) ? g_dk1 : 0.0f)"),
    # K2p and K3p (one circular_phase): the phase's mod is C's fmodf, negative below 0, instead of the floor-mod.
    "k3p_fmodf_phase": (K3P_FILE, "k2pk3p", "*m = a - floorf(a);", "*m = fmodf(a, 1.0f);"),
    # K1: a group's step takes its noise from the next lane of the group (the same distribution: only the parent's
    # bits catch it).
    "k1_noise_from_the_wrong_lane": (K1_FILE, "k1_fixture", "e[k & 3], leader + (k >> 2))",
                                     "e[k & 3], leader + (((k >> 2) + 1) & (G - 1)))"),
    # K1: the refill skips one trial index (the first it would hand out), which is never simulated.
    "k1_refill_skips_a_trial": (K1_FILE, "k1_fixture", "trial = groups + base + ",
                                "trial = groups + 1u + base + "),
    # K1: the chunk's kick lands on its second step.
    "k1_kick_on_the_second_step": (K1_FILE, "k1_fixture", "const int koff = tr.chunk * steps_per_pulse - t;",
                                   "const int koff = tr.chunk * steps_per_pulse + 1 - t;"),
    # K1's per-trial noise scale: a group's first trial takes the next trial's sigma.
    "k1_sigma_of_the_next_trial": (K1_FILE, "k1_sigma",
                                   "float sig = SIG_ROWS ? __fmul_rn(mu_rows[j], sig_sqrt_dt)",
                                   "float sig = SIG_ROWS ? __fmul_rn(mu_rows[(j + 1) % N], sig_sqrt_dt)"),
    # K1's per-trial noise scale: a refilled group keeps its previous trial's sigma.
    "k1_sigma_kept_on_refill": (K1_FILE, "k1_sigma", "if (SIG_ROWS) sig = __fmul_rn(mu_rows[j], sig_sqrt_dt);",
                                "if (SIG_ROWS) sig = sig;"),
    # K1's trial offset: Philox's counter takes the local trial index (a block repeats the first block's noise).
    "k1_counter_ignores_the_offset": (K1_FILE, "k1_offset",
                                      'asm("add.u32 %0, %1, %2;" : "=r"(r) : "r"(trial_offset), "r"(j));',
                                      'asm("mov.u32 %0, %1;" : "=r"(r) : "r"(j));'),
    # K1's trial offset: the output is written at the global index as well (past the block's own rows).
    "k1_output_at_the_global_index": (K1_FILE, "k1_offset", "out[trial] = make_float2(",
                                      "out[noise_trial(trial, trial_offset)] = make_float2("),
}
# check -> (the -k selection of tests/test_torch_cuda.py, the kernel source it builds, whether a fault must fail
# every case: the fused kernels' two sizes each).
CHECKS = {
    "k2k3": ("test_k2_k3_match_their_plain_versions and mnle_10m_shifted_logt_affine", K3_FILE, True),
    "k2pk3p": ("test_k2p_k3p_match_their_plain_versions and mnle_1m_pulseabs", K3P_FILE, True),
    "k1_fixture": ("test_k1_equals_the_parent_k1_bit_for_bit", K1_FILE, False),
    "k1_sigma": ("test_k1_per_trial_noise_scale", K1_FILE, False),
    "k1_offset": ("test_k1_blocks_with_their_offsets_equal_one_launch or test_k1_at_offset_zero_gives_the_parent_bits",
                  K1_FILE, False),
}
# A failed case's message: a check's assertion, or a kernel that faulted or failed to launch.
FAULT_MESSAGES = ("AssertionError", "assert ", "CUDA error", "kernel launch failed", "AcceleratorError")
BUILD = """
import sys
from sbi_for_diffusion_models_tpu_torch.ops import _cuda, ddm_cuda, mnle_cuda  # noqa: F401 (their libraries)
for lib in _cuda._LIBRARIES.values():
    if lib.source.name in sys.argv[1:]:
        lib.load()
"""


def _copy_with_fault(dst: Path, fault) -> None:
    shutil.copytree(ROOT / PKG, dst / PKG, ignore=shutil.ignore_patterns("__pycache__"))
    for f in COPIED:
        (dst / f).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(ROOT / f, dst / f)
    if fault is not None:
        name, _, old, new = fault
        path = dst / PKG / "csrc" / name
        src = path.read_text()
        if src.count(old) != 1:
            raise RuntimeError(f"fault text found {src.count(old)} times in {name}, expected once: {old!r}")
        path.write_text(src.replace(old, new))


def _cases(junit: Path) -> dict:
    """Each case of a pytest run's JUnit report: "passed", "failed" (a
    check's assertion or a kernel's CUDA error), or what else it ended in."""
    out = {}
    for case in ET.parse(junit).iter("testcase"):
        ends = [e for e in case if e.tag in ("failure", "error", "skipped")]
        if not ends:
            out[case.get("name")] = "passed"
        elif ends[0].tag == "failure" and any(m in ends[0].get("message", "") for m in FAULT_MESSAGES):
            out[case.get("name")] = "failed"
        else:
            out[case.get("name")] = f"{ends[0].tag}: {ends[0].get('message', '')[:300]}"
    return out


def _run(tmp: Path, checks: tuple) -> dict:
    """Build the checks' kernel sources in the copy at ``tmp``, then run
    their cases there; {case: verdict}, or {"error": ...} where the build or
    pytest itself failed."""
    build = subprocess.run([sys.executable, "-c", BUILD, *sorted({CHECKS[c][1] for c in checks})], cwd=tmp,
                           capture_output=True, text=True, timeout=900)
    if build.returncode != 0:
        return {"error": f"build rc {build.returncode}: {build.stderr[-4000:]}"}
    junit = tmp / "junit.xml"
    proc = subprocess.run([sys.executable, "-m", "pytest", "-m", "requires_cuda", "tests/test_torch_cuda.py", "-q",
                           "-p", "no:cacheprovider", "-k", " or ".join(f"({CHECKS[c][0]})" for c in checks),
                           f"--junitxml={junit}"], cwd=tmp, capture_output=True, text=True, timeout=1800)
    print(proc.stdout[-6000:], flush=True)
    if proc.returncode not in (0, 1) or not junit.exists():
        return {"error": f"pytest rc {proc.returncode}: {proc.stderr[-4000:]}"}
    return _cases(junit)


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
    results, ok = {}, True
    for name, fault in chosen.items():
        if fault is not None:
            checks = (fault[1],)
        else:  # the unchanged source runs every check, or those of the chosen faults
            checks = tuple(c for c in CHECKS if not names or any(FAULTS[k] and FAULTS[k][1] == c for k in names))
        with tempfile.TemporaryDirectory() as tmp:
            _copy_with_fault(Path(tmp), fault)
            print(f"== {name}: {', '.join(checks)}", flush=True)
            results[name] = r = _run(Path(tmp), checks)
        verdicts = list(r.values())
        if "error" in r or not verdicts:
            ok = False
        elif fault is None:
            ok = ok and all(v == "passed" for v in verdicts)
        elif CHECKS[fault[1]][2]:
            ok = ok and len(verdicts) == 2 and all(v == "failed" for v in verdicts)
        else:
            ok = ok and "failed" in verdicts and all(v in ("passed", "failed") for v in verdicts)
    print(json.dumps({"ok": ok, "results": results}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
