"""Batch iteration: shuffled, transformed, padded — feeding the device.

Replaces torch DataLoader + PyG collate (`main.py:83-89`,
`data/util.py:270-307`).  Batches are already dense, so an "epoch" is one
shuffled pass of array slices with host-side numpy transforms; drop-last
keeps shapes static so the train step never recompiles.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from layoutdm_tpu_torch.data.datasets import LayoutData


def batch_iterator(
    data: LayoutData,
    batch_size: int,
    rng: Optional[np.random.RandomState] = None,
    transform: Optional[Callable] = None,
    shuffle: bool = True,
    drop_last: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    n = len(data)
    idx = np.arange(n)
    if shuffle:
        assert rng is not None
        rng.shuffle(idx)
    stop = n - batch_size + 1 if drop_last else n
    for s in range(0, max(stop, 0), batch_size):
        batch = data.slice(idx[s : s + batch_size])
        if transform is not None:
            batch = transform(rng or np.random.RandomState(0), batch)
        yield batch


def loader_to_list(data: LayoutData) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Dense split -> list of (bbox_valid, label_valid) pairs
    (`data/util.py:289-298`), the layout-list format the metric suite eats."""
    out = []
    for i in range(len(data)):
        m = data.mask[i]
        out.append((data.bbox[i][m], data.label[i][m]))
    return out


def split_num_samples(N: int, batch_size: int) -> List[int]:
    """(`data/util.py:301-307`)"""
    out = [batch_size] * (N // batch_size)
    if N % batch_size:
        out.append(N % batch_size)
    return out
