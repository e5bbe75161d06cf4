"""Launch counts of the hand-written kernels.

Each wrapper adds one to its entry exactly where it launches its kernel and
nowhere else, so a run can show that a path went through the kernels
(``chip_smoke.py`` sets the counts to 0 before the flagship steps and reads
them after)."""

from __future__ import annotations

launch_counts = {"dss_scalar": 0, "dss_vector": 0, "banded_solve": 0,
                 "dss_uvw": 0, "fused_stage": 0, "fused_implicit_update": 0,
                 "nu4_pass1": 0, "nu4_pass2": 0, "dss_state": 0,
                 "dss_scalar2": 0, "banded_solve_multi": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0
