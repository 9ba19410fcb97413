"""The request loops, one module a traffic mix's ``kind``, found by that name.

A mix ``{"kind": "<kind>", ...}`` is run by ``drivers/<kind>.py``, which
defines:

* ``run(ctx) -> (attempted, failed)``: the cell's set-up, one short request
  of its own shapes (so nothing is built or allocated for the first time
  inside the window), ``ctx.probe.start_window()``, then requests in a
  closed loop until the probe closes the window at a call boundary;
* ``numbers(ctx, detail) -> dict``: after the window, the comparison of
  what the timed path produced with the plain reference, the numbers that
  ``limits/<workload>.json`` holds to limits;
* ``control(ctx) -> dict``: the same numbers with the reference in the
  next lower precision in the port's place (``calibrate.py`` and the tests
  only);
* ``FAULTS``: the names of the faults ``calibrate.fault`` plants for it.

``ctx`` carries the configuration, the mix, the seed, the device, the
estimator's path, the probe, ``cards`` and ``memory_peak_bytes`` (the
cards the run uses and the peak of the fullest other than this process's
own: 1 and 0 unless a driver runs ranks on more) and ``data`` (what a
driver keeps for its comparison).
A new kind is a new file here; nothing else names it.
"""

from __future__ import annotations

import importlib

__all__ = ["load"]


def load(kind: str):
    """The driver module of the request kind ``kind``."""
    return importlib.import_module(f"{__name__}.{kind}")
