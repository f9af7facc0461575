"""Model facade: one object per architecture, plus dry-run input specs.

Port of ``repro.models.registry``: ``Model`` (``init``, ``init_cache``,
``forward_train``, ``prefill``, ``decode_step``) and ``build_model``, for
every architecture of the zoo.  The modality frontends are stubs, as in
the reference: ``patches`` / ``frames`` arrive in the batch as
precomputed embeddings.

The dry-run helpers ``init_abstract``, ``cache_abstract`` and
``input_specs`` return tensors on ``meta`` — the counterpart of
``jax.ShapeDtypeStruct`` stand-ins: the reference's shapes and dtypes,
shardable, and never allocated.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tf

META = torch.device("meta")


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

    def init_abstract(self):
        """Shape-only params on ``meta`` (no allocation) for the dry run."""
        return tf.init_params(None, self.cfg)

    def init_cache(self, batch: int, max_len: int):
        enc_len = self.cfg.frontend_len if self.cfg.enc_dec else 0
        return tf.init_cache(self.cfg, batch, max_len, enc_len, self.device)

    def cache_abstract(self, batch: int, max_len: int):
        """The decode cache of ``init_cache`` on ``meta``."""
        enc_len = self.cfg.frontend_len if self.cfg.enc_dec else 0
        return tf.init_cache(self.cfg, batch, max_len, enc_len, META)

    # ---- forwards ------------------------------------------------------
    def forward_train(self, params, batch):
        return tf.forward_train(params, batch, self.cfg)

    def prefill(self, params, batch):
        return tf.prefill(params, batch, self.cfg)

    def decode_step(self, params, cache, token, pos):
        return tf.decode_step(params, cache, token, pos, self.cfg)

    # ---- dry-run input specs -------------------------------------------
    def input_specs(self, shape: ShapeConfig) -> Dict[str, Any]:
        """Every model input of an (arch × shape) cell on ``meta``: the
        train or prefill batch (tokens, labels, patches, frames), or the
        decode cache of length ``seq_len``, one token per sequence and
        the position (an int32 scalar)."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        i32, dt = torch.int32, cfg.torch_dtype

        def sds(shape_, dtype):
            return torch.empty(shape_, dtype=dtype, device=META)

        def token_batch(n_tok):
            batch = {"tokens": sds((b, n_tok), i32)}
            if cfg.frontend == "vision":
                batch["patches"] = sds((b, cfg.frontend_len, cfg.d_model), dt)
            if cfg.enc_dec:
                batch["frames"] = sds((b, cfg.frontend_len, cfg.d_model), dt)
            return batch

        n_tok = s - (cfg.frontend_len if cfg.frontend == "vision" else 0)
        if shape.kind == "train":
            batch = token_batch(n_tok)
            batch["labels"] = sds((b, n_tok), i32)
            return {"batch": batch}
        if shape.kind == "prefill":
            return {"batch": token_batch(n_tok)}
        # decode: one new token against a cache of length s
        return {"cache": self.cache_abstract(b, s),
                "token": sds((b, 1), i32),
                "pos": sds((), i32)}


def build_model(cfg: ModelConfig, device: DeviceLike = "cuda") -> Model:
    return Model(cfg, resolve_device(device))
