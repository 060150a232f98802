"""Profiling hooks: an optional ``torch.profiler`` trace around a region,
written as a Chrome trace that Perfetto and TensorBoard read, and the
named spans of the program's phases that such a trace carries.

The spans (`span`) are ``torch.profiler`` user annotations, so they land in
the same trace as the kernels, on the profiler's clock, whoever started
the profiler.  Where no profiler records they cost an attribute test:
nothing is entered, nothing is kept.

| Span | Where | Once per |
| --- | --- | --- |
| ``layoutdm.step`` | `models.diffusion.sampler.sample_chain`: one reverse step, denoiser call to drawn ids | reverse step |
| ``layoutdm.denoise`` | `make_predict_start`: the denoiser call alone | denoiser call |
| ``layoutdm.attention`` | `models.nn.Block`: the attention sublayer and its residual | layer |
| ``layoutdm.ffn`` | `models.nn.Block`: ``norm2`` through the FFN's residual | layer |
| ``layoutdm.encode`` | `models.bart.BART.sample_ids`: the encoder pass (and, decoding through the cache, the cross keys and values projected from its memory) | chain |
| ``layoutdm.decode_step`` | `BART.sample_ids`: one generated token, decoder call to the forced draw | generated token |
| ``layoutdm.dec_self_attention`` | `models.nn.DecoderBlock`: ``norm1``, the causal self-attention (the cache write and the prefix) and its residual | decoder layer |
| ``layoutdm.cross_attention`` | `DecoderBlock`: ``norm2``, the cross-attention and its residual | decoder layer |
| ``layoutdm.dec_ffn`` | `DecoderBlock`: ``norm3`` through the FFN's residual | decoder layer |
| ``layoutdm.train_step`` | `train.step`: a whole train step | train step |
| ``layoutdm.forward`` | `train.step`: the losses (timesteps, corruption, denoiser, loss) | train step |
| ``layoutdm.backward`` | `train.step._update`: the summed loss, ``zero_grad``, ``backward`` | train step |
| ``layoutdm.optimizer`` | `train.step._update`: averaging over a mesh, the clip, the update, the aux state | train step |
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context naming a phase of the program in a profiler's trace:
    ``torch.profiler.record_function(name)`` while a profiler records,
    else a shared no-op context.  It holds no tensor and waits for
    nothing."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str]) -> Iterator[None]:
    """Trace the region's CPU and CUDA activity, the program's spans
    included, into ``<trace_dir>/trace_<pid>.json`` when a directory is
    given; with none, do nothing.  The profiler leaves grad mode as the
    caller set it (a guided chain runs under ``torch.no_grad``, the others
    under ``torch.inference_mode``)."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace_{os.getpid()}.json"))
