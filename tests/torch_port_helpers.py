"""Shared constructors for the port's parity tests: one tiny flagship-shaped
LayoutDM in both packages on the same weights (flax init -> numpy ->
``params_from_flax``), each built from its own package's configs with the
same fields, and task conditions handed from JAX to the port as numpy."""

import jax
import numpy as np
import torch

from layoutdm_tpu.configs import BackboneConfig, ModelConfig
from layoutdm_tpu.models.layoutdm import LayoutDM as JaxLayoutDM
from layoutdm_tpu.tokenizer.bbox import BboxTokenizer as JaxBbox
from layoutdm_tpu.tokenizer.sequence import LayoutSequenceTokenizer as JaxTok
from layoutdm_tpu_torch import configs as tconfigs
from layoutdm_tpu_torch.models.diffusion.sampler import SamplerCond
from layoutdm_tpu_torch.models.layoutdm import LayoutDM
from layoutdm_tpu_torch.tokenizer.bbox import BboxTokenizer
from layoutdm_tpu_torch.tokenizer.sequence import LayoutSequenceTokenizer
from layoutdm_tpu_torch.utils.params import params_from_flax

# d_model 128 shrinks 29/32 -> 116 = 2 heads of 58, the flagship head width
BACKBONE = dict(
    d_model=128, nhead=2, dim_feedforward=64, num_layers=2, dropout=0.0,
    timestep_type="adalayernorm", diffusion_step=10,
)
NUM_TIMESTEPS = 10
NUM_CATEGORIES = 4
MAX_ELEMENTS = 5  # 25 tokens
NUM_BINS = 8


def tokenizers(num_bins=NUM_BINS, shared_vocab="x-y-w-h", var_order=("x", "y", "w", "h")):
    kw = dict(num_categories=NUM_CATEGORIES, max_elements=MAX_ELEMENTS,
              pad_until_max=True)
    jt = JaxTok(bbox_tokenizer=JaxBbox(num_bins=num_bins, var_order=var_order,
                                       shared_vocab=shared_vocab), **kw)
    tt = LayoutSequenceTokenizer(
        bbox_tokenizer=BboxTokenizer(num_bins=num_bins, var_order=var_order,
                                     shared_vocab=shared_vocab), **kw)
    return jt, tt


def port_layoutdm(tt, backbone=None, num_timesteps=NUM_TIMESTEPS, **kw):
    """The port's tiny LayoutDM on the CPU (its own configs)."""
    bb = dict(BACKBONE, **(backbone or {}))
    return LayoutDM(tconfigs.BackboneConfig(**bb), tt,
                    tconfigs.ModelConfig(num_timesteps=num_timesteps), device="cpu", **kw)


def layoutdm_pair(seed=0, backbone=None, num_timesteps=NUM_TIMESTEPS, **port_kw):
    """(jax model, jax params, port model) on identical weights;
    ``port_kw`` reach the port's `LayoutDM` (the denoiser-path switches)."""
    bb = dict(BACKBONE, **(backbone or {}))
    jt, tt = tokenizers()
    jm = JaxLayoutDM(BackboneConfig(**bb), jt, ModelConfig(num_timesteps=num_timesteps))
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    tm = port_layoutdm(tt, backbone, num_timesteps, **port_kw)
    tm.net.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def layout_batch(rs, B, max_elements=MAX_ELEMENTS, num_categories=NUM_CATEGORIES):
    n = rs.randint(1, max_elements + 1, (B, 1))
    return {
        "label": rs.randint(0, num_categories, (B, max_elements)).astype(np.int32),
        "bbox": rs.rand(B, max_elements, 4).astype(np.float32),
        "mask": np.arange(max_elements)[None] < n,
    }


def cond_to_port(jc) -> SamplerCond:
    """A JAX `SamplerCond` handed over as numpy."""
    return SamplerCond(
        **{k: torch.as_tensor(np.asarray(getattr(jc, k))) for k in SamplerCond.TENSORS},
        init_from_seq=jc.init_from_seq,
    )


def jax_decayed_names(params):
    """The paths where the JAX ``decay_mask`` is true, under the port's
    module names (``layer{i}`` -> ``layers.i``, ``kernel`` -> ``weight``)."""
    from layoutdm_tpu.train.step import decay_mask

    names = set()
    for path, on in jax.tree_util.tree_flatten_with_path(decay_mask(params))[0]:
        if on:
            p = "/".join(getattr(k, "key", str(k)) for k in path)
            names.add(p.replace("/kernel", ".weight").replace("/layer", "/layers/")
                      .replace("/", "."))
    return names
