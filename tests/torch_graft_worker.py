"""The ranks of `tests/test_torch_graft_entry.py`'s batch-sharded programs:
gloo processes on the CPU, spawned with ``torch.multiprocessing``.  Each
rank imports torch and the port only (no jax), rebuilds the tiny LayoutDM
and the FIDNetV3 from the case file the test wrote, takes its rows of the
batch (`parallel.mesh.shard_rows`), runs the deterministic chain and the
feature extractor on them, and the ranks gather the results
(`parallel.mesh.gather_rows`); rank 0 writes what the test compares."""

import os

import torch
import torch.distributed as dist

from layoutdm_tpu_torch import configs as tconfigs
from layoutdm_tpu_torch.eval.fidnet import FIDNetV3, make_feature_extractor
from layoutdm_tpu_torch.models.diffusion.sampler import SamplerCond
from layoutdm_tpu_torch.models.layoutdm import LayoutDM
from layoutdm_tpu_torch.parallel.mesh import gather_rows, make_mesh, shard_batch, shard_rows
from layoutdm_tpu_torch.tokenizer.bbox import BboxTokenizer
from layoutdm_tpu_torch.tokenizer.sequence import LayoutSequenceTokenizer


def build(case):
    tok = LayoutSequenceTokenizer(
        bbox_tokenizer=BboxTokenizer(num_bins=case["num_bins"], shared_vocab="x-y-w-h"),
        num_categories=case["num_categories"], max_elements=case["max_elements"],
        pad_until_max=True)
    model = LayoutDM(tconfigs.BackboneConfig(**case["backbone"]), tok,
                     tconfigs.ModelConfig(num_timesteps=case["num_timesteps"]), device="cpu")
    model.net.load_state_dict(case["state_dict"])
    return model


def sharded(case, mesh):
    """The chain's ids and the features, each rank its rows, gathered."""
    out = {}
    B = case["cond"]["seq"].shape[0]
    lo, hi = shard_rows(B, mesh)
    cond = SamplerCond(**{k: v[lo:hi] for k, v in case["cond"].items()},
                       init_from_seq=case["init_from_seq"])
    own = build(case).sample_ids(torch.arange(lo, hi), hi - lo, cond=cond,
                                 sampling=tconfigs.SamplingConfig(name="deterministic"))
    out["ids"], out["chain_ranks"] = gather_rows(own, mesh)
    fidnet = FIDNetV3(case["fid_labels"], max_bbox=case["fid_max_bbox"], device="cpu")
    fidnet.load_state_dict(case["fid_state_dict"], strict=True)
    rows = shard_batch(case["fid_batch"], mesh)
    own = make_feature_extractor(fidnet)(rows["bbox"], rows["label"], rows["mask"])
    out["features"], out["feature_ranks"] = gather_rows(own, mesh)
    return out


def run(rank, world, case_path):
    torch.set_num_threads(1)
    case = torch.load(case_path, weights_only=False)
    dist.init_process_group("gloo", init_method=f"file://{case['dir']}/store{world}",
                            world_size=world, rank=rank)
    try:
        out = sharded(case, make_mesh(world))
        if rank == 0:
            torch.save(out, os.path.join(case["dir"], f"sharded{world}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()
