"""FIDNet, the layout feature extractor for FID (port of
``layoutdm_tpu/eval/fidnet.py``; reference `fid/model.py`).

FIDNetV3 (`fid/model.py:123-180`): bbox-fc + label-emb -> fused fc -> relu
-> a 4-layer POST-norm transformer encoder (relu, d_ff = d_model / 2) with
a learned CLS token; the 256-d CLS output is the FID feature.  The
auxiliary decoder (broadcast feature + learned positional token ->
per-element class/bbox heads) and the real/fake head are used only when
(re)training the extractor (``eval/fidnet_train.py``).  FIDNetV1 and V2
(`fid/model.py:44-120`) are kept so that old extractor checkpoints load.

The parameter names and shapes are the reference's torch checkpoint's
(``enc_transformer.core.layers.{i}.self_attn.in_proj_weight``, ...), so a
released ``model_best.pth.tar`` loads with ``load_state_dict(strict=True)``.
The attention block is written out in plain ops as the JAX package's
``PostNormBlock`` is (the ``-1e9`` key mask keeps an all-masked row
finite); ``nn.TransformerEncoderLayer`` is not used, since its inference
fast path takes another route on the card than on the CPU.  LayerNorms use
flax's epsilon, 1e-6 (the reference's torch layers use 1e-5).  Features are
float32 with TF32 off.  Models are built on CUDA unless given
``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from layoutdm_tpu_torch.utils.device import require_device

LN_EPS = 1e-6  # flax nn.LayerNorm's default, which the JAX package uses
MASKED = -1e9  # scores of padded keys: finite, so an all-padded row stays finite


class SelfAttention(nn.Module):
    """Multi-head self-attention with ``nn.MultiheadAttention``'s parameter
    names (one packed ``in_proj`` of q, k, v and ``out_proj``)."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor]):
        B, S, D = x.shape
        H = self.nhead
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)
        q, k, v = (t.reshape(B, S, H, D // H) for t in (q, k, v))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D // H)
        if key_padding_mask is not None:
            scores = scores.masked_fill(key_padding_mask[:, None, None, :], MASKED)
        attn = torch.softmax(scores, dim=-1)
        return self.out_proj(torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, S, D))


class PostNormBlock(nn.Module):
    """``nn.TransformerEncoderLayer`` semantics (post-norm, relu, no
    dropout) and parameter names, on batch-first inputs."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int):
        super().__init__()
        self.self_attn = SelfAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, key_padding_mask=None):
        x = self.norm1(x + self.self_attn(x, key_padding_mask))
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


class Encoder(nn.Module):
    """A stack of blocks under ``nn.TransformerEncoder``'s name ``layers``."""

    def __init__(self, d_model: int, nhead: int, num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(
            PostNormBlock(d_model, nhead, d_model // 2) for _ in range(num_layers)
        )

    def forward(self, x, key_padding_mask=None):
        for layer in self.layers:
            x = layer(x, key_padding_mask)
        return x


class TransformerWithToken(nn.Module):
    """The reference's CLS-token encoder (`fid/model.py:8-41`): a learned
    token (1, 1, D) before the elements, never masked."""

    def __init__(self, d_model: int, nhead: int, num_layers: int):
        super().__init__()
        self.token = nn.Parameter(torch.randn(1, 1, d_model))
        self.register_buffer("token_mask", torch.zeros(1, 1, dtype=torch.bool))
        self.core = Encoder(d_model, nhead, num_layers)

    def forward(self, x, padding_mask):
        """(B, S, D), (B, S) True = pad -> (B, 1 + S, D)."""
        B = x.shape[0]
        x = torch.cat([self.token.expand(B, 1, -1), x], dim=1)
        kpm = torch.cat([self.token_mask.expand(B, 1), padding_mask], dim=1)
        return self.core(x, kpm)


class FIDNetV3(nn.Module):
    def __init__(self, num_labels: int, d_model: int = 256, nhead: int = 4,
                 num_layers: int = 4, max_bbox: int = 50, device="cuda"):
        super().__init__()
        D = d_model
        self.num_labels, self.d_model, self.max_bbox = num_labels, d_model, max_bbox
        self.emb_label = nn.Embedding(num_labels, D)
        self.fc_bbox = nn.Linear(4, D)
        self.enc_fc_in = nn.Linear(2 * D, D)
        self.enc_transformer = TransformerWithToken(D, nhead, num_layers)
        self.fc_out_disc = nn.Linear(D, 1)
        self.pos_token = nn.Parameter(torch.rand(max_bbox, 1, D))
        self.dec_fc_in = nn.Linear(2 * D, D)
        self.dec_transformer = Encoder(D, nhead, num_layers)
        self.fc_out_cls = nn.Linear(D, num_labels)
        self.fc_out_bbox = nn.Linear(D, 4)
        self.to(require_device(device))

    def extract_features(self, bbox, label, padding_mask):
        """(B,S,4),(B,S),(B,S) True=pad -> (B, d_model) CLS features
        (`fid/model.py:153-159`)."""
        x = torch.cat([self.fc_bbox(bbox), self.emb_label(label)], dim=-1)
        x = F.relu(self.enc_fc_in(x))
        return self.enc_transformer(x, padding_mask)[:, 0]

    def forward(self, bbox, label, padding_mask):
        """Training heads (`fid/model.py:161-180`): disc logit + per-element
        reconstruction."""
        B, N, _ = bbox.shape
        feat = self.extract_features(bbox, label, padding_mask)
        logit_disc = self.fc_out_disc(feat)[..., 0]
        x = feat[:, None, :].expand(B, N, self.d_model)
        t = self.pos_token[:N, 0][None].expand(B, N, self.d_model)
        x = F.relu(self.dec_fc_in(torch.cat([x, t], dim=-1)))
        x = self.dec_transformer(x, padding_mask)
        return logit_disc, self.fc_out_cls(x), torch.sigmoid(self.fc_out_bbox(x))


class FIDNetV1(nn.Module):
    """`fid/model.py:44-65`: label emb and bbox fc of D/2 each,
    CONCATENATED (label first, no fused projection), 4-layer d=64 CLS
    encoder."""

    def __init__(self, num_labels: int, d_model: int = 64, nhead: int = 4,
                 num_layers: int = 4, device="cuda"):
        super().__init__()
        D = d_model
        self.emb_label = nn.Embedding(num_labels, D // 2)
        self.fc_bbox = nn.Linear(4, D // 2)
        self.transformer = TransformerWithToken(D, nhead, num_layers)
        self.fc_out = nn.Linear(D, 1)
        self.to(require_device(device))

    def extract_features(self, bbox, label, padding_mask):
        x = torch.cat([self.emb_label(label), self.fc_bbox(bbox)], dim=-1)
        return self.transformer(x, padding_mask)[:, 0]

    def forward(self, bbox, label, padding_mask):
        return self.fc_out(self.extract_features(bbox, label, padding_mask))[..., 0]


class FIDNetV2(nn.Module):
    """`fid/model.py:68-120`: 128+128 concat (label first), 8-layer d=256
    CLS encoder, a batch-normed real/fake head (run in eval mode); the
    reconstruction decoder prepends the feature to learned positional
    tokens."""

    def __init__(self, num_labels: int, d_model: int = 256, nhead: int = 4,
                 num_layers: int = 8, max_bbox: int = 50, device="cuda"):
        super().__init__()
        D = d_model
        self.d_model = d_model
        self.emb_label = nn.Embedding(num_labels, D // 2)
        self.fc_bbox = nn.Linear(4, D // 2)
        self.encoder = TransformerWithToken(D, nhead, num_layers)
        self.fc_out = nn.Sequential(
            nn.Linear(D, D // 2), nn.BatchNorm1d(D // 2), nn.ReLU(),
            nn.Linear(D // 2, D // 4), nn.BatchNorm1d(D // 4), nn.ReLU(),
            nn.Linear(D // 4, 1),
        )
        self.token = nn.Parameter(torch.rand(max_bbox, 1, D))
        self.decoder = Encoder(D, nhead, num_layers)
        self.fc_out_cls = nn.Linear(D, num_labels)
        self.fc_out_bbox = nn.Linear(D, 4)
        self.to(require_device(device))
        self.eval()

    def extract_features(self, bbox, label, padding_mask):
        x = torch.cat([self.emb_label(label), self.fc_bbox(bbox)], dim=-1)
        return self.encoder(x, padding_mask)[:, 0]

    def forward(self, bbox, label, padding_mask):
        B, N, _ = bbox.shape
        feat = self.extract_features(bbox, label, padding_mask)
        logit = self.fc_out(feat)[..., 0]
        t = self.token[:N, 0][None].expand(B, N, self.d_model)
        x = torch.cat([feat[:, None, :], t], dim=1)
        kpm = torch.cat([torch.zeros_like(padding_mask[:, :1]), padding_mask], dim=1)
        x = self.decoder(x, kpm)[:, 1:]
        return logit, self.fc_out_cls(x), torch.sigmoid(self.fc_out_bbox(x))


@contextlib.contextmanager
def full_float32():
    """float32 matmuls without TF32 inside the block."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


def make_feature_extractor(model: nn.Module) -> Callable:
    """(bbox, label, mask) numpy or tensors, mask True = valid -> (B, d)
    float32 features on the model's device."""
    device = next(model.parameters()).device
    model.eval()

    @torch.no_grad()
    def extract(bbox, label, mask):
        bbox = torch.as_tensor(bbox, dtype=torch.float32, device=device)
        label = torch.as_tensor(label, device=device).long()
        mask = torch.as_tensor(mask, device=device).bool()
        with full_float32():
            return model.extract_features(bbox, label, ~mask)

    return extract


# ---------------------------------------------------------------------------
# checkpoints: the reference's torch files and the JAX package's msgpack
# ---------------------------------------------------------------------------


def _read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    sd = torch.load(path, map_location="cpu", weights_only=False)
    return sd["state_dict"] if "state_dict" in sd else sd


def _load(model: nn.Module, sd: Dict[str, torch.Tensor]) -> nn.Module:
    # the token masks are constant zeros; files written from a module that
    # does not register them (the JAX package's tests) lack them
    for name, buf in model.named_buffers():
        if name.endswith("token_mask"):
            sd.setdefault(name, buf)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def load_torch_fidnet(path: str, num_labels: int, max_bbox: int = 50,
                      device="cuda") -> FIDNetV3:
    """A reference ``model_best.pth.tar`` (or one ``fidnet_train`` wrote)
    as a FIDNetV3 on ``device``."""
    model = FIDNetV3(num_labels=num_labels, max_bbox=max_bbox, device=device)
    return _load(model, _read_state_dict(path))


def load_torch_fidnet_v1(path: str, num_labels: int, device="cuda") -> FIDNetV1:
    return _load(FIDNetV1(num_labels=num_labels, device=device), _read_state_dict(path))


def load_torch_fidnet_v2(path: str, num_labels: int, max_bbox: int = 50,
                         device="cuda") -> FIDNetV2:
    model = FIDNetV2(num_labels=num_labels, max_bbox=max_bbox, device=device)
    return _load(model, _read_state_dict(path))


def load_fidnet_v3(dataset_name: str, num_labels: int, weight_dir: str,
                   max_bbox: int = 25, device="cuda") -> FIDNetV3:
    """Resolve weights as the JAX package does (`fid/model.py:183-193`):
    ``{weight_dir}/{name}-max{S}/model_best.msgpack`` (a JAX FIDNet's flax
    params) first, else ``model_best.pth.tar`` (torch).  Raises
    FileNotFoundError when neither exists."""
    from layoutdm_tpu_torch.utils.flax_msgpack import read_flax_msgpack

    prefix = os.path.join(weight_dir, f"{dataset_name}-max{max_bbox}")
    flax_path = os.path.join(prefix, "model_best.msgpack")
    if os.path.exists(flax_path):
        model = FIDNetV3(num_labels=num_labels, max_bbox=max_bbox, device=device)
        return _load(model, fidnet_params_from_flax(read_flax_msgpack(flax_path)))
    return load_torch_fidnet(os.path.join(prefix, "model_best.pth.tar"), num_labels,
                             max_bbox, device)


def fidnet_params_from_flax(params, batch_stats=None) -> Dict[str, torch.Tensor]:
    """A JAX FIDNet's params (nested dicts of arrays; V3, V1, or V2 with
    its ``batch_stats``) as the matching torch module's state dict."""
    t = lambda a: torch.as_tensor(np.array(a, dtype=np.float32))
    sd: Dict[str, torch.Tensor] = {}

    def dense(prefix, p):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = t(p["kernel"]).T, t(p["bias"])

    def block(prefix, p):
        sd[f"{prefix}.self_attn.in_proj_weight"] = t(p["qkv"]["kernel"]).T
        sd[f"{prefix}.self_attn.in_proj_bias"] = t(p["qkv"]["bias"])
        dense(f"{prefix}.self_attn.out_proj", p["out"])
        for name in ("linear1", "linear2"):
            dense(f"{prefix}.{name}", p[name])
        for name in ("norm1", "norm2"):
            sd[f"{prefix}.{name}.weight"] = t(p[name]["scale"])
            sd[f"{prefix}.{name}.bias"] = t(p[name]["bias"])

    def blocks(prefix, stem):
        i = 0
        while f"{stem}{i}" in params:
            block(f"{prefix}.{i}", params[f"{stem}{i}"])
            i += 1

    sd["emb_label.weight"] = t(params["emb_label"]["embedding"])
    dense("fc_bbox", params["fc_bbox"])
    # the CLS-token encoder's name: V3, V1, V2
    enc = ("enc_transformer" if "enc_fc_in" in params
           else "transformer" if "fc_out" in params else "encoder")
    sd[f"{enc}.token"] = t(params["cls_token"]).permute(1, 0, 2).contiguous()
    sd[f"{enc}.token_mask"] = torch.zeros(1, 1, dtype=torch.bool)
    blocks(f"{enc}.core.layers", "enc")
    if enc == "enc_transformer":  # V3
        blocks("dec_transformer.layers", "dec")
        sd["pos_token"] = t(params["pos_token"])
        for name in ("enc_fc_in", "fc_out_disc", "dec_fc_in", "fc_out_cls", "fc_out_bbox"):
            dense(name, params[name])
    elif enc == "transformer":  # V1
        dense("fc_out", params["fc_out"])
    else:  # V2: fc_out is Linear-BN-ReLU-Linear-BN-ReLU-Linear
        blocks("decoder.layers", "dec")
        sd["token"] = t(params["pos_token"])
        for name in ("fc_out_cls", "fc_out_bbox"):
            dense(name, params[name])
        for i, name in ((0, "fc_out_1"), (3, "fc_out_2"), (6, "fc_out_3")):
            dense(f"fc_out.{i}", params[name])
        for i, name in ((1, "bn_1"), (4, "bn_2")):
            sd[f"fc_out.{i}.weight"] = t(params[name]["scale"])
            sd[f"fc_out.{i}.bias"] = t(params[name]["bias"])
            sd[f"fc_out.{i}.running_mean"] = t(batch_stats[name]["mean"])
            sd[f"fc_out.{i}.running_var"] = t(batch_stats[name]["var"])
            sd[f"fc_out.{i}.num_batches_tracked"] = torch.tensor(0)
    return sd
