"""Reference PyTorch checkpoints -> the port's weights (port of
``layoutdm_tpu/utils/torch_port.py``).

The released weights (``{best,final}_model.pt``, saved at
`models/common/util.py:60-64`) are a torch ``state_dict``; LayoutDM's keys
sit under ``model.module.transformer.``, the zoo's (MaskGIT, BLT, RUITE,
LayoutTransformer) under ``model.module.``, and every encoder-only family
shares one key map (`nn_lib.py:137-237`, `transformer_utils.py:34-246`).
DiffusionLM and BitDiffusion have their own (`convert_continuous_transformer`:
a Dense input embedding, DiffusionLM's codebook and rounder beside the
transformer), and so has BART (`convert_categorical_encdec_transformer`,
whose cross-attention ``in_proj`` splits into q and kv).  Both sides store
Dense weights (out, in), so the maps rename keys and copy tensors (or row
blocks of them): no transposes, no flax tree in between.  Each map has its
inverse (``*to_reference_state_dict``).  The schedule
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


# (reference key, port key, the reference tensor's rows the port key takes)
Pair = Tuple[str, str, Optional[slice]]


def _dense(ref: str, port: str) -> List[Pair]:
    return [(f"{ref}.weight", f"{port}.weight", None), (f"{ref}.bias", f"{port}.bias", None)]


def _pos_kind(keys, name: str) -> str:
    """Which positional embedding (`nn_lib.py:73-134`) ``name`` holds
    among ``keys``: learned absolute, or element + attribute (with the
    BOS slot)."""
    if f"{name}.pos_emb" in keys:
        return "default"
    return "elem_bos" if f"{name}.bos_emb" in keys else "elem"


def _pos(ref: str, port: str, kind: str) -> List[Pair]:
    if kind == "default":
        return [(f"{ref}.pos_emb", f"{port}.pos_emb", None)]
    names = ["elem_emb", "attr_emb"] + (["bos_emb"] if kind == "elem_bos" else [])
    return [(f"{ref}.{n}", f"{port}.{n}", None) for n in names]


def _encoder(ref: str, port: str, num_layers: int, timestep_type: Optional[str]) -> List[Pair]:
    """A `TransformerEncoder` (`transformer_utils.py:103-246`)."""
    pairs = []
    for i in range(num_layers):
        r, p = f"{ref}.layers.{i}", f"{port}.layers.{i}"
        if timestep_type is None:
            pairs += _dense(f"{r}.norm1", f"{p}.norm1")
        else:
            cond = f"{p}.norm1.cond"
            pairs += _dense(f"{r}.norm1.linear", f"{cond}.linear")
            if "mlp" in timestep_type:
                pairs += _dense(f"{r}.norm1.emb.1", f"{cond}.mlp1")
                pairs += _dense(f"{r}.norm1.emb.3", f"{cond}.mlp2")
            elif "abs" not in timestep_type:
                pairs.append((f"{r}.norm1.emb.weight", f"{cond}.emb.weight", None))
        pairs += [(f"{r}.self_attn.in_proj_weight", f"{p}.attn.qkv.weight", None),
                  (f"{r}.self_attn.in_proj_bias", f"{p}.attn.qkv.bias", None)]
        pairs += _dense(f"{r}.self_attn.out_proj", f"{p}.attn.out")
        pairs += _dense(f"{r}.linear1", f"{p}.linear1")
        pairs += _dense(f"{r}.linear2", f"{p}.linear2")
        pairs += _dense(f"{r}.norm2", f"{p}.norm2")
    return pairs


def _head() -> List[Pair]:
    return _dense("head.0", "head_norm") + [("head.1.weight", "head.weight", None)]


def _key_map(num_layers: int, timestep_type: Optional[str], pos_kind: str) -> List[Pair]:
    """A `CategoricalTransformer` (`nn_lib.py:137-237`)."""
    return ([("cat_emb.weight", "cat_emb.weight", None)] + _pos("pos_emb", "pos", pos_kind)
            + _encoder("backbone", "backbone", num_layers, timestep_type) + _head())


def _continuous_key_map(num_layers: int, timestep_type: Optional[str],
                        pos_kind: str) -> List[Pair]:
    """A `ContinuousTransformer` (`nn_lib.py:240-313`): a Dense over
    concat(self_cond, x) in place of the token embedding."""
    return (_dense("emb", "emb") + _pos("pos_emb", "pos", pos_kind)
            + _encoder("backbone", "backbone", num_layers, timestep_type) + _head())


def _encdec_key_map(num_layers: int, d_model: int, pos_kinds: Tuple[str, str]) -> List[Pair]:
    """A `CategoricalEncDecTransformer` (`nn_lib.py:316-400`): the encoder's
    Blocks, and torch ``TransformerDecoderLayer(norm_first=True)`` layers,
    whose cross-attention ``in_proj`` splits into q (the first D rows) and
    the packed kv (the rest)."""
    pairs = [("input_cat_emb.weight", "input_emb.weight", None),
             ("target_cat_emb.weight", "target_emb.weight", None)]
    pairs += _pos("input_pos_emb", "input_pos", pos_kinds[0])
    pairs += _pos("target_pos_emb", "target_pos", pos_kinds[1])
    pairs += _encoder("encoder", "encoder", num_layers, None)
    q, kv = slice(0, d_model), slice(d_model, None)
    for i in range(num_layers):
        r, p = f"decoder.layers.{i}", f"dec{i}"
        pairs += _dense(f"{r}.norm1", f"{p}.norm1")
        pairs += [(f"{r}.self_attn.in_proj_weight", f"{p}.self_attn.qkv.weight", None),
                  (f"{r}.self_attn.in_proj_bias", f"{p}.self_attn.qkv.bias", None)]
        pairs += _dense(f"{r}.self_attn.out_proj", f"{p}.self_attn.out")
        pairs += _dense(f"{r}.norm2", f"{p}.norm2")
        for rows, name in ((q, "q"), (kv, "kv")):
            pairs += [(f"{r}.multihead_attn.in_proj_weight", f"{p}.cross_attn.{name}.weight", rows),
                      (f"{r}.multihead_attn.in_proj_bias", f"{p}.cross_attn.{name}.bias", rows)]
        pairs += _dense(f"{r}.multihead_attn.out_proj", f"{p}.cross_attn.out")
        pairs += _dense(f"{r}.norm3", f"{p}.norm3")
        pairs += _dense(f"{r}.linear1", f"{p}.linear1")
        pairs += _dense(f"{r}.linear2", f"{p}.linear2")
    return pairs + _head()


def _convert(sd: Dict, pairs: List[Pair], prefix: str) -> Dict[str, torch.Tensor]:
    """The port's keys from a reference state dict (float32 CPU copies)."""
    out = {}
    for ref, port, rows in pairs:
        t = sd[prefix + ref]
        out[port] = (t if rows is None else t[rows]).detach().to("cpu", torch.float32).clone()
    return out


def _invert(sd: Dict, pairs: List[Pair], prefix: str) -> Dict[str, torch.Tensor]:
    """The reference keys from the port's state dict; row blocks of one
    reference tensor are joined in the map's order."""
    parts: Dict[str, list] = {}
    for ref, port, _ in pairs:
        parts.setdefault(prefix + ref, []).append(sd[port].detach().to("cpu"))
    return {ref: torch.cat(ts) for ref, ts in parts.items()}


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
    pairs = _key_map(num_layers, timestep_type, _pos_kind(sd, prefix + "pos_emb"))
    return _convert(sd, pairs, prefix)


def to_reference_state_dict(
    sd: Dict[str, torch.Tensor],
    num_layers: int,
    timestep_type: Optional[str] = "adalayernorm",
    prefix: str = "transformer.",
) -> Dict[str, torch.Tensor]:
    """The port's state dict under the reference's key names (the inverse
    of `convert_categorical_transformer`)."""
    return _invert(sd, _key_map(num_layers, timestep_type, _pos_kind(sd, "pos")), prefix)


def _codec_prefix(prefix: str) -> str:
    """Where DiffusionLM's ``token_emb`` and ``rounder`` sit: beside the
    ``transformer.`` of ``prefix``."""
    return prefix[: -len("transformer.")] if prefix.endswith("transformer.") else prefix


_CODEC = [("token_emb.weight", "token_emb", None), ("rounder.weight", "rounder.weight", None),
          ("rounder.bias", "rounder.bias", None)]


def convert_continuous_transformer(
    sd: Dict,
    num_layers: int,
    timestep_type: Optional[str] = "adalayernorm_mlp",
    prefix: str = "transformer.",
) -> Dict[str, torch.Tensor]:
    """A reference `ContinuousTransformer` state dict -> the port's
    `models.continuous.base.ContinuousTransformer` keys; where the state
    dict holds DiffusionLM's ``token_emb.weight`` and ``rounder`` beside
    the transformer, they come too (the net of `DiffusionLM`)."""
    out = _convert(sd, _continuous_key_map(num_layers, timestep_type,
                                           _pos_kind(sd, prefix + "pos_emb")), prefix)
    codec = _codec_prefix(prefix)
    if codec + "rounder.weight" in sd:
        out.update(_convert(sd, _CODEC, codec))
    return out


def continuous_to_reference_state_dict(
    sd: Dict[str, torch.Tensor],
    num_layers: int,
    timestep_type: Optional[str] = "adalayernorm_mlp",
    prefix: str = "transformer.",
) -> Dict[str, torch.Tensor]:
    """The inverse of `convert_continuous_transformer`."""
    ref = _invert(sd, _continuous_key_map(num_layers, timestep_type, _pos_kind(sd, "pos")),
                  prefix)
    if "rounder.weight" in sd:
        ref.update(_invert(sd, _CODEC, _codec_prefix(prefix)))
    return ref


def convert_categorical_encdec_transformer(
    sd: Dict,
    num_layers: int,
    d_model: int,
    prefix: str = "",
) -> Dict[str, torch.Tensor]:
    """A reference `CategoricalEncDecTransformer` state dict (BART) -> the
    port's `models.nn.CategoricalEncDecTransformer` keys."""
    kinds = (_pos_kind(sd, prefix + "input_pos_emb"), _pos_kind(sd, prefix + "target_pos_emb"))
    return _convert(sd, _encdec_key_map(num_layers, d_model, kinds), prefix)


def encdec_to_reference_state_dict(
    sd: Dict[str, torch.Tensor],
    num_layers: int,
    d_model: int,
    prefix: str = "",
) -> Dict[str, torch.Tensor]:
    """The inverse of `convert_categorical_encdec_transformer`."""
    kinds = (_pos_kind(sd, "input_pos"), _pos_kind(sd, "target_pos"))
    return _invert(sd, _encdec_key_map(num_layers, d_model, kinds), prefix)


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
