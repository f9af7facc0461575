"""Model facade: one object per architecture.

Port of ``repro.models.registry`` for inference: ``Model`` (``init``,
``init_cache``, ``prefill``, ``decode_step``) and ``build_model``, for
every architecture of the zoo.  The modality frontends are stubs, as in
the reference: ``patches`` / ``frames`` arrive in the prefill batch as
precomputed embeddings.  ``forward_train`` waits for ROADMAP's training
slice, and the dry-run helpers ``init_abstract``, ``cache_abstract`` and
``input_specs`` for its multi-device and analysis item.
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
    def prefill(self, params, batch):
        return tf.prefill(params, batch, self.cfg)

    def decode_step(self, params, cache, token, pos):
        return tf.decode_step(params, cache, token, pos, self.cfg)


def build_model(cfg: ModelConfig, device: DeviceLike = "cuda") -> Model:
    return Model(cfg, resolve_device(device))
