"""Reference PyTorch checkpoints -> the port's weights (port of
``layoutdm_tpu/utils/torch_port.py``).

The released weights (``{best,final}_model.pt``, saved at
`models/common/util.py:60-64`) are a torch ``state_dict``; LayoutDM's keys
sit under ``model.module.transformer.``, the zoo's (MaskGIT, BLT, RUITE,
LayoutTransformer) under ``model.module.``, and every encoder-only family
shares one key map (`nn_lib.py:137-237`, `transformer_utils.py:34-246`).
Both sides store Dense weights (out, in), so the map renames keys and
copies tensors: no transposes, no flax tree in between.  The schedule
buffers are not read (the port recomputes them from the config); the
importance-sampling buffers become an `LtState`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from layoutdm_tpu_torch.models.diffusion.loss import LtState


def load_torch_state_dict(path: str) -> Dict[str, Any]:
    """A reference checkpoint's state dict (its ``"state_dict"`` entry
    where there is one).  ``torch.load(..., weights_only=False)``, as the
    JAX importer loads it: the released files pickle more than tensors, so
    load only files you trust."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


def strip_prefix(sd: Dict, prefix: str = "model.module.") -> Dict:
    return {(k[len(prefix):] if k.startswith(prefix) else k): v for k, v in sd.items()}


def _key_map(sd_keys, num_layers: int, timestep_type: Optional[str],
             prefix: str) -> List[Tuple[str, str]]:
    """(reference key, port key) pairs of a `CategoricalTransformer`."""
    pairs = [("cat_emb.weight", "cat_emb.weight")]
    # positional embedding variants (`nn_lib.py:73-134`), the BOS slot too
    if prefix + "pos_emb.pos_emb" in sd_keys:
        pairs.append(("pos_emb.pos_emb", "pos.pos_emb"))
    else:
        pairs += [("pos_emb.elem_emb", "pos.elem_emb"), ("pos_emb.attr_emb", "pos.attr_emb")]
        if prefix + "pos_emb.bos_emb" in sd_keys:
            pairs.append(("pos_emb.bos_emb", "pos.bos_emb"))

    def dense(ref, port):
        return [(f"{ref}.weight", f"{port}.weight"), (f"{ref}.bias", f"{port}.bias")]

    for i in range(num_layers):
        ref, port = f"backbone.layers.{i}", f"backbone.layers.{i}"
        if timestep_type is None:
            pairs += dense(f"{ref}.norm1", f"{port}.norm1")
        else:
            cond = f"{port}.norm1.cond"
            pairs += dense(f"{ref}.norm1.linear", f"{cond}.linear")
            if "mlp" in timestep_type:
                pairs += dense(f"{ref}.norm1.emb.1", f"{cond}.mlp1")
                pairs += dense(f"{ref}.norm1.emb.3", f"{cond}.mlp2")
            elif "abs" not in timestep_type:
                pairs.append((f"{ref}.norm1.emb.weight", f"{cond}.emb.weight"))
        pairs += [(f"{ref}.self_attn.in_proj_weight", f"{port}.attn.qkv.weight"),
                  (f"{ref}.self_attn.in_proj_bias", f"{port}.attn.qkv.bias")]
        pairs += dense(f"{ref}.self_attn.out_proj", f"{port}.attn.out")
        pairs += dense(f"{ref}.linear1", f"{port}.linear1")
        pairs += dense(f"{ref}.linear2", f"{port}.linear2")
        pairs += dense(f"{ref}.norm2", f"{port}.norm2")
    pairs += dense("head.0", "head_norm")
    pairs.append(("head.1.weight", "head.weight"))
    return [(prefix + ref, port) for ref, port in pairs]


def convert_categorical_transformer(
    sd: Dict,
    num_layers: int,
    timestep_type: Optional[str] = "adalayernorm",
    prefix: str = "transformer.",
) -> Dict[str, torch.Tensor]:
    """A reference `CategoricalTransformer` state dict -> the port's
    `models.nn.CategoricalTransformer` keys (float32 CPU copies).
    ``timestep_type``: None (the zoo's plain LayerNorm), ``adalayernorm``,
    ``..._mlp`` or ``..._abs`` (no parameters in its timestep embedding)."""
    return {
        port: sd[ref].detach().to("cpu", torch.float32).clone()
        for ref, port in _key_map(sd.keys(), num_layers, timestep_type, prefix)
    }


def to_reference_state_dict(
    sd: Dict[str, torch.Tensor],
    num_layers: int,
    timestep_type: Optional[str] = "adalayernorm",
    prefix: str = "transformer.",
) -> Dict[str, torch.Tensor]:
    """The port's state dict under the reference's key names (the inverse
    of `convert_categorical_transformer`)."""
    keys = {prefix + "pos_emb." + k[len("pos."):] for k in sd if k.startswith("pos.")}
    return {
        ref: sd[port].detach().to("cpu").clone()
        for ref, port in _key_map(keys, num_layers, timestep_type, prefix)
    }


def import_layoutdm_checkpoint(
    path: str,
    num_layers: int = 4,
    timestep_type: Optional[str] = "adalayernorm",
) -> Tuple[Dict[str, torch.Tensor], LtState]:
    """A reference LayoutDM ``.pt`` -> (the denoiser's state dict, its
    `LtState`).  The schedule buffers (``{key}_log_at`` etc.) are not read:
    `ops.log_math.ScheduleTables` rebuilds them from the config with the
    same float64 construction."""
    sd = strip_prefix(load_torch_state_dict(path))
    params = convert_categorical_transformer(sd, num_layers, timestep_type)
    lt = LtState(
        history=sd["Lt_history"].detach().to("cpu", torch.float32).clone(),
        count=sd["Lt_count"].detach().to("cpu", torch.float32).clone(),
    )
    return params, lt
