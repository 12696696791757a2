"""INI configuration — the same schema and fields as
sdf_representation_tpu/configgen/config_reader.py (reference
configgen/config_reader.py:8-108), building the port's torch model.

Kept from the JAX package: every section and field name, the rule that
``skip_connection = 0`` disables the skip and forces beta = 0 (ReLU + tanh,
reference config_reader.py:26-32), and the optional ``[TPU]`` keys.
``use_pallas`` keeps its name: here it means "use the hand-written kernels",
and ``False`` is accepted only on the CPU, where the plain path runs anyway.
A HashMLP's ``[Model]`` may also set its encoding (``HASH_ENCODING_KEYS``),
which the JAX package's reader does not read.
``epochs_per_call`` sizes the labelled trainer's block, as it sizes the JAX
trainer's jitted multi-epoch call: that many epochs and their validation
run with the best epoch's state kept on the device, and the host reads the
losses once per block (training/trainer.py, training/graphs.py).
"""

from __future__ import annotations

import configparser
from typing import Tuple

import torch

from ..losses.losses import get_loss_class
from ..models import KAN, FeedForwardNetwork, HashMLP, ImplicitNet, Siren
from ..models.registry import get_model_class


# [Model] keys of a HashMLP's encoding, each optional: absent, the model's
# own default (8 levels of 2^15 x 2, resolutions 8 to 256, the point read
# beside the features). ``num_hidden_layers`` counts its affine layers
# (``num_layers = max(2, n)``): two hidden layers are 3.
HASH_ENCODING_KEYS = ("n_levels", "n_features", "log2_table_size", "base_resolution",
                      "max_resolution", "include_xyz")


class Configuration:
    def __init__(self, file_path: str = "config.ini"):
        self.config = configparser.ConfigParser()
        read = self.config.read(file_path)
        if not read:
            raise FileNotFoundError(f"Config file not found or unreadable: {file_path}")

        # [Files]
        self.geometry = self.config.get("Files", "geometry")
        self.directory = self.config.get("Files", "directory")
        self.name = self.config.get("Files", "name")

        # [Model]
        self.model_name = self.config.get("Model", "model")
        self.hidden_dim = self.config.getint("Model", "hidden_dim")
        self.num_hidden_layers = self.config.getint("Model", "num_hidden_layers")
        self.input_dim = self.config.getint("Model", "input_dim", fallback=3)
        if self.model_name in ("ImplicitNet", "ImplicitNetCompatible"):
            val = self.config.getint("Model", "skip_connection")
            if val == 0:
                self.skip_connection: Tuple[int, ...] = ()
                self.beta = 0.0
            else:
                self.skip_connection = (val,)
                self.beta = self.config.getfloat("Model", "beta")
            self.geometric_init = self.config.getboolean("Model", "geometric_init")
            self.lipschitz = self.config.getboolean("Model", "lipschitz", fallback=False)
            self.lipschitz_weight = self.config.getfloat(
                "Model", "lipschitz_weight", fallback=1e-6
            )
        else:
            self.skip_connection = ()
            self.beta = 0.0
            self.geometric_init = False
            self.lipschitz = False
            self.lipschitz_weight = 0.0

        # [Loss]
        self.loss_name = self.config.get("Loss", "loss_function")
        self.loss_kwargs = {
            key: float(self.config.get("Loss", key))
            for key in self.config.options("Loss")
            if key != "loss_function"
        }

        # [Training]
        self.lr = self.config.getfloat("Training", "lr")
        self.epochs = self.config.getint("Training", "epochs")
        self.minepochs = self.config.getint("Training", "min_epochs")
        self.batchsize = self.config.getint("Training", "batch_size")
        self.checkpointing = self.config.getint("Training", "checkpointing")
        self.contd = self.config.getboolean("Training", "continue")
        self.patience = self.config.getint("Training", "patience")
        self.two_dim = self.config.getboolean("Training", "two_dim", fallback=False)
        self.lr_step = self.config.getint("Training", "lr_step", fallback=0)
        self.lr_gamma = self.config.getfloat("Training", "lr_gamma", fallback=0.5)

        # [Sampling]
        self.samplingonly = self.config.getboolean("Sampling", "samplingonly")
        self.continue_sampling = self.config.getboolean("Sampling", "continue_sampling")
        self.rescale = self.config.getboolean("Sampling", "rescale")
        self.distributed = self.config.getboolean("Sampling", "distributed")
        self.uniform_points = self.config.getint("Sampling", "uniform_points")
        self.surface = self.config.getint("Sampling", "surface")
        self.narrowband = self.config.getint("Sampling", "narrowband")
        self.narrowband_width = self.config.getfloat("Sampling", "narrowband_width")
        self.mismatchuse = self.config.getboolean("Sampling", "mismatchuse")
        self.train_test_split = self.config.getfloat("Sampling", "train_test_split")

        # [Optional]
        self.ppo = self.config.getboolean("Optional", "ppo")
        self.reconstruct = self.config.getboolean("Optional", "reconstruct")
        self.cubesize = self.config.getint("Optional", "cubesize")
        self.ppbatchsize = self.config.getint("Optional", "postprocessbatchsize")

        # [TPU] — extensions beyond the reference schema (all optional)
        self.mesh_devices = self.config.getint("TPU", "mesh_devices", fallback=0)
        self.compute_dtype = self.config.get("TPU", "compute_dtype", fallback="float32")
        self.use_pallas = self.config.getboolean("TPU", "use_pallas", fallback=True)
        self.epochs_per_call = self.config.getint("TPU", "epochs_per_call", fallback=1)
        self.debug_nans = self.config.getboolean("TPU", "debug_nans", fallback=False)
        tp = self.config.get("TPU", "train_matmul_precision", fallback="default")
        self.train_matmul_precision = None if tp in ("default", "none") else tp

    def hash_encoding(self) -> dict:
        """The ``HASH_ENCODING_KEYS`` that a HashMLP's ``[Model]`` sets (a
        method, so that the parsed fields stay the JAX package's)."""
        out = {}
        for key in HASH_ENCODING_KEYS if self.model_name == "HashMLP" else ():
            if self.config.has_option("Model", key):
                read = self.config.getboolean if key == "include_xyz" else self.config.getint
                out[key] = read("Model", key)
        return out

    def make_model(self, generator: torch.Generator | None = None,
                   device: torch.device | str | None = None):
        """Build the torch model from the parsed fields, as the JAX package's
        ``make_model`` does per family (weights from ``generator``, seed 0
        when none is given)."""
        cls = get_model_class(self.model_name)
        kw = dict(generator=generator, device=device)
        if self.model_name in ("ImplicitNet", "ImplicitNetCompatible"):
            return ImplicitNet(
                d_in=self.input_dim,
                hidden_dims=(self.hidden_dim,) * self.num_hidden_layers,
                skip_in=self.skip_connection,
                beta=self.beta,
                geometric_init=self.geometric_init,
                lipschitz=self.lipschitz,
                lipschitz_weight=self.lipschitz_weight,
                **kw,
            )
        if self.model_name == "FeedForwardNetwork":
            return FeedForwardNetwork(d_in=self.input_dim, hidden_dim=self.hidden_dim,
                                      num_layers=self.num_hidden_layers, **kw)
        if self.model_name == "KAN":
            layers = (self.input_dim,) + (self.hidden_dim,) * self.num_hidden_layers + (1,)
            return KAN(layers_hidden=layers, **kw)
        if self.model_name == "HashMLP":
            return HashMLP(d_in=self.input_dim, hidden_dim=self.hidden_dim,
                           num_layers=max(2, self.num_hidden_layers), **self.hash_encoding(), **kw)
        if self.model_name == "Siren":
            return Siren(d_in=self.input_dim,
                         hidden_dims=(self.hidden_dim,) * self.num_hidden_layers,
                         omega_0=self.config.getfloat("Model", "omega_0", fallback=30.0), **kw)
        return cls(**kw)

    def make_loss(self):
        """The configured loss, with the [Loss] section's other keys as its
        fields."""
        return get_loss_class(self.loss_name)(**self.loss_kwargs)
