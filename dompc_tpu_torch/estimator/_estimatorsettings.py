"""Estimator settings (reference: do_mpc/estimator/_estimatorsettings.py)."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class EstimatorSettings:
    t_step: float | None = None
    n_horizon: int | None = None

    def check_for_mandatory_settings(self):
        assert self.n_horizon is not None, "n_horizon must be set."
        assert self.t_step is not None, "t_step must be set."


@dataclass
class MHESettings(EstimatorSettings):
    meas_from_data: bool = False
    state_discretization: str = "collocation"
    collocation_type: str = "radau"
    collocation_deg: int = 2
    collocation_ni: int = 1
    nl_cons_check_colloc_points: bool = False
    nl_cons_single_slack: bool = False
    cons_check_colloc_points: bool = True
    store_full_solution: bool = False
    store_lagr_multiplier: bool = True
    store_solver_stats: list = field(
        default_factory=lambda: ["success", "t_wall_total"])
    nlpsol_opts: dict = field(default_factory=dict)
    solver_tol: float = 1e-8
    solver_max_iter: int = 150
    warm_start_mu: float = 1e-4
    solver_mu_init: float = 1e-1       # IPOPT mu_init
    solver_reg_retries: int = 5        # regularization-ladder length
    solver_use_soc: bool = True        # second-order correction step
    solver_do_polish: bool = True      # active-set Newton polish
    solver_ls_max: int = 25            # max halvings in line search
    kkt_solver: str = "auto"   # 'auto' | 'dense' | 'tridiag' (bordered band)

    def supress_ipopt_output(self):
        """API compatibility (our solver is silent)."""
