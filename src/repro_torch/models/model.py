"""Model registry + parameter init glue for the assigned architectures (port
of ``repro/models/model.py``).

``abstract_params`` / ``input_specs`` / ``abstract_cache`` give tensors on
the meta device where the reference gives ``jax.ShapeDtypeStruct``s: shapes
and dtypes, nothing allocated.  :func:`params_from_numpy` carries the
reference's parameter pytree across, and :class:`DecoderLM` holds such a
dict as ``nn.Parameter``s around the functional API.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.core.state import resolve_device
from repro_torch.models import transformer
from repro_torch.models.config import SHAPES, ModelConfig
from repro_torch.models.frontends import prefix_spec
from repro_torch.pytree import tree_leaves, tree_map


def get_config(name: str) -> ModelConfig:
    from repro_torch import configs

    return configs.get(name)


def list_archs() -> list[str]:
    from repro_torch import configs

    return sorted(configs.REGISTRY)


def init_params(rng, cfg: ModelConfig, param_dtype=torch.float32, *, device=None):
    return transformer.init_params(rng, cfg, param_dtype, device=device)


def param_count(params) -> int:
    return sum(t.numel() for t in tree_leaves(params))


def abstract_params(cfg: ModelConfig, param_dtype=torch.float32):
    """The parameter dict on the meta device (no allocation)."""
    return transformer.init_params(0, cfg, param_dtype, device="meta")


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """Meta-device stand-ins for every model input of a shape cell."""
    sh = SHAPES[shape_name]
    B, S = sh["global_batch"], sh["seq_len"]

    def spec(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")

    if sh["kind"] in ("train", "prefill"):
        text = S - (cfg.frontend_len if cfg.frontend else 0)
        specs = {"tokens": spec(B, text)}
        if sh["kind"] == "train":
            specs["targets"] = spec(B, text)
        pf = prefix_spec(cfg, B)
        if pf is not None:
            specs["prefix_embeds"] = pf
        return specs
    # decode: one new token against a seq_len cache
    return {"token": spec(B)}


def abstract_cache(cfg: ModelConfig, shape_name: str, dtype=torch.bfloat16):
    sh = SHAPES[shape_name]
    return transformer.init_cache(cfg, sh["global_batch"], sh["seq_len"], dtype,
                                  device="meta")


def params_from_numpy(tree, device=None):
    """A pytree of numpy arrays (``np.asarray`` of the reference's
    parameters, nested dicts and lists) as the port's dict of tensors, in
    the same layout and dtypes, on the card unless ``device`` names another.
    A bfloat16 array (``ml_dtypes``) crosses as its 16-bit pattern, so no
    value is rounded."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.array(a, order="C")  # a copy the tensor may own and write
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        return t.to(dev)

    return tree_map(leaf, tree)


class DecoderLM(nn.Module):
    """The decoder as a module: the parameter dict's tensors as parameters
    (names joined by ``.``), ``forward`` and ``decode_step`` through the
    functional API on :attr:`params`, a view of the same tensors."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self._tree = self._register(self, params)

    @staticmethod
    def _register(module: nn.Module, tree: dict) -> dict:
        out = {}
        for name, v in tree.items():
            if isinstance(v, dict):
                child = nn.Module()
                module.add_module(name, child)
                out[name] = DecoderLM._register(child, v)
            else:
                p = nn.Parameter(v, requires_grad=False)
                module.register_parameter(name, p)
                out[name] = p
        return out

    @property
    def params(self) -> dict:
        return self._tree

    def forward(self, tokens, prefix_embeds=None, **kw):
        with torch.no_grad():
            return transformer.forward(self._tree, self.cfg, tokens, prefix_embeds, **kw)

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16):
        return transformer.init_cache(self.cfg, batch, max_len, dtype,
                                      device=self.embed.device)

    def decode_step(self, cache, token):
        with torch.no_grad():
            return transformer.decode_step(self._tree, self.cfg, cache, token)
