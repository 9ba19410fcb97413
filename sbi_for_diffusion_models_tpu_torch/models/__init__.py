"""Simulators (PyTorch port): the RT+choice pulse DDM and the choice-only
model, as the JAX package's ``models`` exports them. The 7-parameter model
(``pulse_ddm_7p``) and the hierarchical model (``hierarchical``) are
submodules here, as there.
"""

from .choice_model import (
    ChoiceModelParams,
    choice_model_simulator,
    choice_model_simulator_torch,
    generate_pulse_sides,
)
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
    "ChoiceModelParams",
    "choice_model_simulator",
    "choice_model_simulator_torch",
    "generate_pulse_sides",
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
