"""ApproxMPC settings (reference: do_mpc/approximateMPC/_ampcsettings.py)."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ApproximateMPCSettings:
    n_hidden_layers: int = 3
    n_neurons: int = 50
    act_fn: str = "tanh"
    output_act_fn: str = "linear"


@dataclass
class AMPCSamplerSettings:
    dataset_name: str = "approx_mpc_data"
    n_samples: int = 1000
    trajectory_length: int = 1   # >1 -> closed-loop sampling
    closed_loop_flag: bool = False
    data_dir: str = "./sampling"
    overwrite_sampler: bool = True


@dataclass
class TrainerSettings:
    n_epochs: int = 200
    batch_size: int = 128
    learning_rate: float = 1e-3
    train_split: float = 0.8
    shuffle: bool = True
    scheduler_flag: bool = False
    scheduler_patience: int = 10
    scheduler_factor: float = 0.5
    print_frequency: int = 10
    show_fig: bool = False
    save_fig: bool = False
    save_history: bool = False
    results_dir: str = "./training"
    # The JAX package shards training batches over all visible devices.
    # The port trains on one device, where the JAX package switches it off
    # too; the field is kept for the shared settings.
    data_parallel: bool = True
