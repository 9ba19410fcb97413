"""Physics/time-discretization constants for the pulse-DDM simulators.

Mirrors the reference constants module (reference: src/sbi_for_diffusion_models/
constants.py:2-5). ``DT`` is kept for API parity although it is unused by any
simulator (it is a dead legacy constant in the reference as well).
"""

# Legacy fine step size -- declared but unused (parity with reference constants.py:2).
DT = 1e-6

# Euler-Maruyama step of the RT+choice / choice simulators (reference constants.py:3).
DT_CHOICE = 5e-4

# Trial ceiling in seconds (reference constants.py:4).
T_MAX = 8.0

# Interval between stimulus pulses in seconds, i.e. 100 ms (reference constants.py:5).
PULSE_INTERVAL = 0.1
