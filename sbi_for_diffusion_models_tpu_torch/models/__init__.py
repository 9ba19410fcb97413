"""Simulators (PyTorch port): the RT+choice pulse DDM.

The choice-only model's names (``ChoiceModelParams``,
``choice_model_simulator``, ``choice_model_simulator_torch``,
``generate_pulse_sides``) are not ported yet.
"""

from .rt_choice_model import (
    RTChoiceModelParams,
    as_pulse_tensor,
    generate_pulse_matrix,
    generate_pulse_matrix_numpy,
    n_pulses_max_from_schedule,
    pack_x_rt_choice,
    pulse_schedule,
    rt_choice_model_simulator,
    rt_choice_model_simulator_torch,
    simulate_session_data_rt_choice,
)

__all__ = [
    "RTChoiceModelParams",
    "as_pulse_tensor",
    "generate_pulse_matrix",
    "generate_pulse_matrix_numpy",
    "n_pulses_max_from_schedule",
    "pack_x_rt_choice",
    "pulse_schedule",
    "rt_choice_model_simulator",
    "rt_choice_model_simulator_torch",
    "simulate_session_data_rt_choice",
]
