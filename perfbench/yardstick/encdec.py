"""Analytic work of the encoder-decoder (BART) cells from the
configuration: what the model must compute and move, not what an
implementation happens to do, so that no faster decode can read above
its bound.  A multiply-add counts 2; norms, softmax and the draw are
left out.  Sizes: d, heads, FFN width and layers as run
(`reference.encdec.widths`), M = 5 E + 1 encoder positions (the memory),
G = 5 E generated tokens, V the vocabulary."""

from __future__ import annotations

from typing import Dict

from perfbench.reference.encdec import Vocab, widths


def _sizes(cfg: Dict):
    d, _, ff, L = widths(cfg)
    v = Vocab.of(cfg)
    return d, ff, L, v.seq_len, v.gen_len, v.size


def _decoder_layer_weights(d: int, ff: int) -> int:
    """Weights a decoder layer reads a step: the self-attention's qkv and
    out, the cross-attention's q and out, the FFN (the cross keys' and
    values' projection runs once a chain)."""
    return 6 * d * d + 2 * d * ff


def flops_per_layout(cfg: Dict) -> int:
    """One sampled layout: the encoder over M tokens (its GEMMs, scores
    and weighted sums), the cross keys and values projected from the
    memory in every layer, and G decode steps, each the decoder's GEMMs,
    self-attention over the p + 1 positions so far, cross-attention over
    the M memory positions, and the head."""
    d, ff, L, M, G, V = _sizes(cfg)
    encoder = M * L * (2 * (4 * d * d + 2 * d * ff) + 2 * 2 * M * d)
    cross_kv = M * L * 2 * (2 * d * d)
    decoder = G * (L * (2 * _decoder_layer_weights(d, ff) + 2 * 2 * M * d) + 2 * d * V)
    prefix = L * 2 * 2 * d * sum(p + 1 for p in range(G))
    return encoder + cross_kv + decoder + prefix


def decode_step_work(cfg: Dict, batch: int, elem_bytes: int = 2):
    """(bytes, flops) of one cached decode step of ``batch`` rows, the mean
    over a chain's G steps: the decoder's weights read once; every
    layer's self keys and values read up to the step's position and the
    step's own written; the cross keys and values read; the step's
    float32 logits written.  Operations: the GEMMs of each row, its
    attention over the prefix and the memory, the head."""
    d, ff, L, M, G, V = _sizes(cfg)
    mean_prefix = sum(p + 1 for p in range(G)) / G
    weights = L * _decoder_layer_weights(d, ff) + d * V
    self_kv = batch * L * 2 * d * (mean_prefix + 1)
    cross_kv = batch * L * 2 * M * d
    nbytes = (weights + self_kv + cross_kv) * elem_bytes + batch * V * 4
    flops = batch * (L * (2 * _decoder_layer_weights(d, ff) + 2 * 2 * (mean_prefix + M) * d)
                     + 2 * d * V)
    return nbytes, flops
