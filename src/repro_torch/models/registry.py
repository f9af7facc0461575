"""Model facade: one object per architecture.

Port of ``repro.models.registry``: ``Model`` (``init``, ``init_cache``,
``forward_train``, ``prefill``, ``decode_step``) and ``build_model``, for
every architecture of the zoo.  The modality frontends are stubs, as in
the reference: ``patches`` / ``frames`` arrive in the batch as
precomputed embeddings.  The dry-run helpers ``init_abstract``,
``cache_abstract`` and ``input_specs`` wait for ROADMAP's multi-device
and analysis item.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tf


@dataclass
class Model:
    cfg: ModelConfig
    device: torch.device

    # ---- param / cache construction ----------------------------------
    def init(self, generator: torch.Generator):
        """Parameters drawn from ``generator``, which must live on the
        model's device."""
        if torch.device(generator.device).type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}")
        return tf.init_params(generator, self.cfg)

    def init_cache(self, batch: int, max_len: int):
        enc_len = self.cfg.frontend_len if self.cfg.enc_dec else 0
        return tf.init_cache(self.cfg, batch, max_len, enc_len, self.device)

    # ---- forwards ------------------------------------------------------
    def forward_train(self, params, batch):
        return tf.forward_train(params, batch, self.cfg)

    def prefill(self, params, batch):
        return tf.prefill(params, batch, self.cfg)

    def decode_step(self, params, cache, token, pos):
        return tf.decode_step(params, cache, token, pos, self.cfg)


def build_model(cfg: ModelConfig, device: DeviceLike = "cuda") -> Model:
    return Model(cfg, resolve_device(device))
