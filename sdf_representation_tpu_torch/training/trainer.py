"""Trainer of the port — so far only what reconstruction needs.

Counterpart of sdf_representation_tpu/training/trainer.py: the run-directory
tree (trainer.py:391-438, reference executor/executor.py:29-48), checkpoint
loading (trainer.py:690-717) and the mode dispatch of ``run``
(trainer.py:742-759). Sampling, training and the accuracy audit are the next
slice of the port (ROADMAP.md) and raise NotImplementedError.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import torch

from ..configgen.config_reader import Configuration
from ..utils.device import resolve_device
from ..utils.files import create_directory
from . import checkpoint as ckpt


class Trainer:
    """Run directories, model and checkpoints for one config.

    ``device``: None runs on the card (and raises without one); "cpu" runs
    the plain PyTorch path. ``compute_dtype`` is the working type of the
    fused kernels (bfloat16, as in the JAX package's TPU path, or float32).
    """

    def __init__(self, config: Configuration, device=None, init_seed: int = 0,
                 compute_dtype: torch.dtype = torch.bfloat16):
        self.config = config
        self.device = resolve_device(device)
        if self.device.type == "cuda" and not config.use_pallas:
            raise ValueError(
                "use_pallas = False selects the plain PyTorch path, which the "
                "port runs only on the CPU (pass device='cpu')"
            )
        self.init_seed = init_seed
        self.compute_dtype = compute_dtype
        self.geometry_name = config.name

        c = config
        self.main_path = create_directory(
            os.path.join(c.directory, f"r_{self.geometry_name}")
        )
        self.data_path = create_directory(
            os.path.join(
                self.main_path,
                f"config_uniform{c.uniform_points},surface_{c.surface},"
                f"narrowband_{c.narrowband},narrowband_width_{c.narrowband_width}",
            )
        )
        with open(os.path.join(self.data_path, "info.txt"), "w") as f:
            f.write(
                f"config_uniform{c.uniform_points},surface_{c.surface},"
                f"narrowband_{c.narrowband},narrowband_width_{c.narrowband_width}"
            )
        self.model_path = create_directory(
            os.path.join(
                self.data_path,
                f"{c.model_name},hidden_dim_{c.hidden_dim},"
                f"num_hidden_layers_{c.num_hidden_layers},"
                f"skip_connection_{c.skip_connection},beta_{c.beta},"
                f"geometric_init_{c.geometric_init}",
            )
        )
        self.loss_path = create_directory(
            os.path.join(self.model_path, f"loss_{c.loss_name}")
        )
        self.train_path = create_directory(
            os.path.join(
                self.loss_path,
                f"lr_{c.lr},epochs_{c.epochs},min_epochs_{c.minepochs},"
                f"batch_size_{c.batchsize}",
            )
        )
        self.model_save_path = create_directory(os.path.join(self.train_path, "models"))
        self.postprocess_save_path = create_directory(
            os.path.join(self.train_path, "postprocess")
        )
        self.plot_save_path = create_directory(os.path.join(self.train_path, "plots"))

        self.model = config.make_model(
            generator=torch.Generator().manual_seed(init_seed), device=self.device
        )

    def load_model(self, best: bool = True) -> Tuple[Dict[str, torch.Tensor], int]:
        """Load best_model.ckpt (``best``) or the newest model_epoch*.ckpt
        into ``self.model``; returns (state_dict, epoch)."""
        best_path = os.path.join(self.model_save_path, "best_model.ckpt")
        newest = ckpt.latest_epoch_checkpoint(self.model_save_path)
        if best and os.path.exists(best_path) or newest is None:
            if not os.path.exists(best_path):
                raise FileNotFoundError(f"No checkpoint found in {self.model_save_path}")
            state = ckpt.load_checkpoint(best_path)
            epoch = int(state["epoch"])
        else:
            state = ckpt.load_checkpoint(newest[0])
            epoch = newest[1]
        self.model.load_state_dict(state["model"])
        return state["model"], epoch

    def run(self):
        """cf. Executor.run (reference executor.py:481-499)."""
        c = self.config
        if c.samplingonly:
            raise NotImplementedError("sampling is slice 2 of the port, see ROADMAP.md")
        if c.ppo:
            if c.reconstruct:
                from ..evaluations.reconstruct import reconstruct_only

                return reconstruct_only(self, compute_dtype=self.compute_dtype)
            raise NotImplementedError(
                "the accuracy audit (post_process) is slice 2 of the port, see ROADMAP.md"
            )
        raise NotImplementedError("training is slice 2 of the port, see ROADMAP.md")
