"""LayoutDM's BART baseline, written out plainly in float32 (reference
implementation; no import of the program).

The encoder-decoder of LayoutDM's code (``models/bart.py`` over
``CategoricalEncDecTransformer``, ``models/common/nn_lib.py:316-400``):

- The vocabulary: the categories, then 32 bins shared by x, y, w and h
  (``shared_bbox_vocab = "xywh"``), then PAD, BOS, EOS and MASK.  A layout
  of E elements is ``BOS c1 w1 h1 x1 y1 c2 ...`` (``var_order =
  "c-w-h-x-y"``), 5 E + 1 tokens; EOS takes the category slot after the
  last element, PAD every slot of the elements after it.  Boxes are
  quantized linearly as in LayoutDM's vocabulary (`reference.tokens`).
- The encoder: token embedding plus learned absolute positions, then
  ``num_layers`` blocks whose first LayerNorm replaces the trunk, as
  LayoutDM's code has it (``x = LN1(x); x = x + attn(x); x = x +
  FFN(LN2(x))``), with no mask.
- The decoder: its own token embedding and positions, ``num_layers``
  norm-first blocks (``x = x + self_attn(LN1(x))`` under a causal mask,
  ``x = x + cross_attn(LN2(x), memory)``, ``x = x + FFN(LN3(x))``), then
  a final LayerNorm and a bias-free head over the vocabulary.
- Decoding: position i (after BOS) may hold only its attribute's tokens,
  PAD or EOS (`Vocab.legal`); a condition's tokens are forced.

LayerNorms use eps 1e-6 and the FFN a ReLU.  Widths are the
configuration's after BART's own 21/32 shrink.  ``param_spec`` names
every parameter with the names the program's state dict uses, so one set
of tensors made by the benchmark serves both sides.

``lowp`` computes every product with its operands rounded to a lower
precision (``"fp8"``: float8 e4m3 with a per-tensor scale, as
`reference.denoiser` has it), the control that has to fail the
comparison.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

LN_EPS = 1e-6
ATTRS = ("c", "w", "h", "x", "y")
SPECIALS = ("pad", "bos", "eos", "mask")


@dataclass(frozen=True)
class Vocab:
    num_categories: int
    max_elements: int
    num_bins: int = 32

    @classmethod
    def of(cls, cfg: Dict) -> "Vocab":
        if cfg["shared_bbox_vocab"] != "xywh" or cfg["var_order"] != "c-w-h-x-y":
            raise ValueError("the reference spells out the shared xywh bins in c-w-h-x-y order")
        if cfg["bbox_quantization"] != "linear" or tuple(cfg["special_tokens"]) != SPECIALS:
            raise ValueError("the reference spells out linear bins and (pad, bos, eos, mask)")
        return cls(cfg["num_categories"], cfg["max_elements"], cfg["num_bins"])

    @property
    def size(self) -> int:
        return self.num_categories + self.num_bins + len(SPECIALS)

    def special(self, name: str) -> int:
        return self.num_categories + self.num_bins + SPECIALS.index(name)

    @property
    def pad(self) -> int:
        return self.special("pad")

    @property
    def bos(self) -> int:
        return self.special("bos")

    @property
    def eos(self) -> int:
        return self.special("eos")

    @property
    def mask(self) -> int:
        return self.special("mask")

    @property
    def gen_len(self) -> int:
        """Tokens a decode generates (BOS left out)."""
        return 5 * self.max_elements

    @property
    def seq_len(self) -> int:
        return self.gen_len + 1

    def legal(self) -> torch.Tensor:
        """(gen_len, V) the tokens position i after BOS may hold: the
        attribute's own (categories or bins), PAD and EOS."""
        C, n = self.num_categories, self.num_bins
        out = torch.zeros((5, self.size), dtype=torch.bool)
        out[0, :C] = True
        out[1:, C:C + n] = True
        out[:, [self.pad, self.eos]] = True
        return out.repeat(self.max_elements, 1)

    def _bins(self, bbox: torch.Tensor) -> torch.Tensor:
        """(..., 4) xywh boxes -> (..., 4) bin ids in w, h, x, y order."""
        n, d = self.num_bins, 1.0 / self.num_bins
        bbox = bbox.float()
        xy = bbox[..., :2].clamp(0.0, 1.0 - d)
        wh = bbox[..., 2:].clamp(d, 1.0) - d
        bins = torch.round(n * torch.cat([wh, xy], -1)).long()
        return bins + self.num_categories

    def encode(self, label: torch.Tensor, bbox: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """(B, E) labels, (B, E, 4) boxes, (B, E) validity (valid elements
        first) -> (B, seq_len) ids with BOS and EOS."""
        B, E = label.shape
        mask = mask.bool()
        el = torch.cat([label.long()[..., None], self._bins(bbox)], -1)
        el = torch.where(mask[..., None], el, self.pad)
        n_valid = mask.sum(1)
        first_pad = torch.arange(E, device=label.device)[None] == n_valid[:, None]
        el[..., 0] = torch.where(first_pad, self.eos, el[..., 0])
        bos = torch.full((B, 1), self.bos, dtype=torch.long, device=label.device)
        return torch.cat([bos, el.reshape(B, 5 * E)], 1)

    def c_task(self, label: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """LayoutDM's ``c`` task (category given, size and position
        generated): the encoder's input (BOS, each element's category and
        MASK for its box, PAD for the elements past the last), and the
        decoded positions the condition fixes with the tokens it fixes
        (each category, every slot of the elements past the last as PAD).
        Returns (enc_ids (B, seq_len), forced (B, gen_len), forced_ids)."""
        B, E = label.shape
        mask = mask.bool()
        el = torch.full((B, E, 5), self.mask, dtype=torch.long, device=label.device)
        el[..., 0] = label.long()
        el = torch.where(mask[..., None], el, self.pad).reshape(B, 5 * E)
        first = (torch.arange(5 * E, device=label.device) % 5 == 0)[None]
        forced = first | ~mask.repeat_interleave(5, 1)
        bos = torch.full((B, 1), self.bos, dtype=torch.long, device=label.device)
        return torch.cat([bos, el], 1), forced, el

    def decode(self, ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, gen_len) ids after BOS -> label, bbox (xywh) and the mask of
        well-formed elements: a category, then one bin of each coordinate,
        and no EOS in a category slot at or before it."""
        C, n = self.num_categories, self.num_bins
        el = ids.reshape(ids.shape[0], -1, 5)
        label, bins = el[..., 0], el[..., 1:] - C
        ok = (label >= 0) & (label < C) & ((bins >= 0) & (bins < n)).all(-1)
        ok &= torch.cumsum((label == self.eos).long(), 1) == 0
        w, h, x, y = bins.float().unbind(-1)
        grid = torch.stack([x / n, y / n, (w + 1) / n, (h + 1) / n], -1)
        return {"label": torch.where(ok, label, 0),
                "bbox": torch.where(ok[..., None], grid, 0.0), "mask": ok}


def widths(cfg: Dict) -> Tuple[int, int, int, int]:
    """(d_model, heads, ffn width, layers) as run."""
    num, den = cfg["width_shrink"]
    return (cfg["d_model"] * num // den, cfg["nhead"], cfg["dim_feedforward"] * num // den,
            cfg["num_layers"])


def _linear_spec(name: str, n_out: int, n_in: int, bias: bool = True):
    return [(name + ".weight", (n_out, n_in), "w")] + ([(name + ".bias", (n_out,), "b")]
                                                        if bias else [])


def _norm_spec(name: str, d: int):
    return [(name + ".weight", (d,), "one"), (name + ".bias", (d,), "zero")]


def param_spec(cfg: Dict, vocab_size: int) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every parameter; kinds as
    `reference.denoiser.param_spec` draws them (``w``: N(0, 1/fan_in),
    ``b``: N(0, 0.02^2), ``emb``: N(0, 1/d), ``pos``: U[0, 1), ``one``:
    1 + N(0, 0.1^2), ``zero``: N(0, 0.1^2))."""
    d, _, ff, L = widths(cfg)
    S = 5 * cfg["max_elements"] + 1
    spec = [("input_emb.weight", (vocab_size, d), "emb"),
            ("target_emb.weight", (vocab_size, d), "emb"),
            ("input_pos.pos_emb", (S, d), "pos"), ("target_pos.pos_emb", (S, d), "pos")]
    for i in range(L):
        p = f"encoder.layers.{i}."
        spec += (_norm_spec(p + "norm1", d) + _linear_spec(p + "attn.qkv", 3 * d, d)
                 + _linear_spec(p + "attn.out", d, d) + _linear_spec(p + "linear1", ff, d)
                 + _linear_spec(p + "linear2", d, ff) + _norm_spec(p + "norm2", d))
    for i in range(L):
        p = f"dec{i}."
        spec += (_norm_spec(p + "norm1", d) + _linear_spec(p + "self_attn.qkv", 3 * d, d)
                 + _linear_spec(p + "self_attn.out", d, d) + _norm_spec(p + "norm2", d)
                 + _linear_spec(p + "cross_attn.q", d, d)
                 + _linear_spec(p + "cross_attn.kv", 2 * d, d)
                 + _linear_spec(p + "cross_attn.out", d, d) + _norm_spec(p + "norm3", d)
                 + _linear_spec(p + "linear1", ff, d) + _linear_spec(p + "linear2", d, ff))
    return spec + _norm_spec("head_norm", d) + _linear_spec("head", vocab_size, d, bias=False)


def make_params(cfg: Dict, vocab_size: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter in float32 on ``device``, from ``seed``: one normal
    and one uniform draw on a generator there, cut into the leaves."""
    spec = param_spec(cfg, vocab_size)
    n = sum(math.prod(s) for _, s, _ in spec)
    g = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(n, generator=g, device=device)
    uniform = torch.rand(n, generator=g, device=device)
    out, off = {}, 0
    for name, shape, kind in spec:
        k = math.prod(shape)
        z, u = normal[off:off + k].view(shape), uniform[off:off + k].view(shape)
        off += k
        if kind in ("w", "emb"):  # fan-in of a kernel, width of an embedding
            v = z / math.sqrt(shape[1])
        elif kind == "pos":
            v = u.clone()
        elif kind == "b":
            v = 0.02 * z
        elif kind == "one":
            v = 1.0 + 0.1 * z
        else:
            v = 0.1 * z
        out[name] = v.contiguous()
    return out


def _round(x: torch.Tensor, lowp: Optional[str]) -> torch.Tensor:
    """x rounded to float8 e4m3 with a per-tensor scale (its largest
    magnitude mapped to 448), back in float32, for ``lowp="fp8"``."""
    if lowp is None:
        return x
    if lowp != "fp8":
        raise ValueError(f"unknown precision {lowp!r}")
    s = x.abs().amax().clamp(min=1e-12) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _lin(p: Dict, name: str, x: torch.Tensor, lowp: Optional[str] = None) -> torch.Tensor:
    return F.linear(_round(x, lowp), _round(p[name + ".weight"], lowp), p.get(name + ".bias"))


def _ln(p: Dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"], p[name + ".bias"], LN_EPS)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, H: int,
            causal: bool = False, lowp: Optional[str] = None) -> torch.Tensor:
    """(B, Sq, d) queries over (B, Sk, d) keys and values, H heads."""
    B, Sq, d = q.shape
    hd = d // H
    qh, kh, vh = (_round(t, lowp).reshape(B, t.shape[1], H, hd).transpose(1, 2)
                  for t in (q, k, v))
    scores = qh @ kh.transpose(-1, -2) / math.sqrt(hd)
    if causal:
        Sk = k.shape[1]
        scores = scores.masked_fill(torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
                                    .triu(1), -torch.inf)
    return (torch.softmax(scores, -1) @ vh).transpose(1, 2).reshape(B, Sq, d)


def _ffn(p: Dict, pre: str, x: torch.Tensor, lowp: Optional[str]) -> torch.Tensor:
    return _lin(p, pre + "linear2", F.relu(_lin(p, pre + "linear1", x, lowp)), lowp)


def encode(p: Dict[str, torch.Tensor], cfg: Dict, ids: torch.Tensor,
           lowp: Optional[str] = None) -> torch.Tensor:
    """(B, S) encoder ids -> (B, S, d) float32 memory."""
    d, H, _, L = widths(cfg)
    x = p["input_emb.weight"][ids] + p["input_pos.pos_emb"][:ids.shape[1]][None]
    for i in range(L):
        q = f"encoder.layers.{i}."
        x = _ln(p, q + "norm1", x)  # replaces the trunk, as LayoutDM's code has it
        a, b, c = _lin(p, q + "attn.qkv", x, lowp).chunk(3, -1)
        x = x + _lin(p, q + "attn.out", _attend(a, b, c, H, lowp=lowp), lowp)
        x = x + _ffn(p, q, _ln(p, q + "norm2", x), lowp)
    return x


def decode(p: Dict[str, torch.Tensor], cfg: Dict, memory: torch.Tensor,
           ids: torch.Tensor, lowp: Optional[str] = None) -> torch.Tensor:
    """(B, S) decoder ids (BOS first) over ``memory`` -> (B, S, V) float32
    logits; position j's predict the token after it."""
    d, H, _, L = widths(cfg)
    x = p["target_emb.weight"][ids] + p["target_pos.pos_emb"][:ids.shape[1]][None]
    for i in range(L):
        q = f"dec{i}."
        a, b, c = _lin(p, q + "self_attn.qkv", _ln(p, q + "norm1", x), lowp).chunk(3, -1)
        x = x + _lin(p, q + "self_attn.out", _attend(a, b, c, H, True, lowp), lowp)
        h = _ln(p, q + "norm2", x)
        k, v = _lin(p, q + "cross_attn.kv", memory, lowp).chunk(2, -1)
        o = _attend(_lin(p, q + "cross_attn.q", h, lowp), k, v, H, lowp=lowp)
        x = x + _lin(p, q + "cross_attn.out", o, lowp)
        x = x + _ffn(p, q, _ln(p, q + "norm3", x), lowp)
    return _lin(p, "head", _ln(p, "head_norm", x), lowp)


def forward(p: Dict[str, torch.Tensor], cfg: Dict, enc_ids: torch.Tensor,
            dec_ids: torch.Tensor, lowp: Optional[str] = None) -> torch.Tensor:
    """The teacher-forced pass: logits of ``dec_ids`` over the memory of
    ``enc_ids``."""
    return decode(p, cfg, encode(p, cfg, enc_ids, lowp), dec_ids, lowp)
