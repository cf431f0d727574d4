"""Controller settings dataclasses
(reference: do_mpc/controller/_controllersettings.py:27-176)."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ControllerSettings:
    t_step: float | None = None

    def check_for_mandatory_settings(self):
        assert self.t_step is not None, "t_step must be set."


@dataclass
class MPCSettings(ControllerSettings):
    n_horizon: int | None = None
    n_robust: int = 0
    open_loop: bool = False
    use_terminal_bounds: bool = False
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
    # solver controls (replace IPOPT options; full passthrough mirroring the
    # reference's nlpsol_opts surface, _controllersettings.py:139-175)
    solver_tol: float = 1e-8
    solver_tol_loop: float | None = None  # barrier-loop exit tolerance:
                                # set looser than solver_tol (e.g. 1e-5)
                                # to let the active-set polish carry the
                                # last decades — the B=1 latency recipe
                                # (success still certified at solver_tol)
    solver_max_iter: int = 150
    warm_start_mu: float = 1e-4
    solver_mu_init: float = 1e-1       # IPOPT mu_init
    solver_mu_min_factor: float = 0.1  # barrier floor = solver_tol * this
                                # (lower for problems whose central path
                                # sits far from the KKT point, e.g. DIP)
    solver_reg_retries: int = 5        # regularization-ladder length
    solver_use_soc: bool = True        # second-order correction step
    solver_do_polish: bool = True      # active-set Newton polish
    solver_ls_max: int = 25            # max halvings in line search
    solver_rti_iters: int = 0          # >0: real-time-iteration mode for
                                # warm make_step calls — exactly this many
                                # Newton steps at the warm-start barrier,
                                # no convergence loop (the acados-style
                                # fixed-latency receding-horizon path; the
                                # cold first solve still runs the full
                                # globalized loop).  Not ported yet: a
                                # value above 0 raises NotImplementedError,
                                # and the RTI damping/decay knobs come with
                                # it.
    solver_globalization: str = "filter"  # 'filter': Wächter-Biegler
                                # (theta, phi) filter line search (the
                                # IPOPT globalization; converges the DIP
                                # swing-up).  'merit': legacy l1-merit
                                # acceptance.
    kkt_solver: str = "auto"   # 'auto' | 'dense' | 'tridiag'
    condense_z: str = "auto"   # 'auto': AD-probe whether nl_cons depend
                               # on algebraic vars (z-independent ->
                               # Schur-eliminate the z interior);
                               # 'never': always keep the conservative
                               # uncondensed band (use for piecewise
                               # constraints whose z-branch could be
                               # inactive on the probe domain)
    # integer-input (MINLP) strategy — reference delegates to BONMIN
    # branch-and-bound (_mpc.py:1317-1324); 'bnb' is the batched
    # branch-and-bound (solver/minlp.py), 'round' rounds the relaxation
    minlp_strategy: str = "bnb"   # 'bnb' | 'round'
    bnb_max_nodes: int = 64
    bnb_batch_width: int = 8

    def check_for_mandatory_settings(self):
        assert self.n_horizon is not None, "n_horizon must be set."
        assert self.t_step is not None, "t_step must be set."

    def supress_ipopt_output(self):
        """Kept for API compatibility (reference :152); our solver is silent."""

    def set_linear_solver(self, solver_name: str = "MA27"):
        """Kept for API compatibility (reference :160); the KKT factorization
        is chosen via ``kkt_solver``."""


@dataclass
class LQRSettings:
    n_horizon: int | None = None
    t_step: float | None = None

    def check_for_mandatory_settings(self):
        assert self.t_step is not None, "t_step must be set."
