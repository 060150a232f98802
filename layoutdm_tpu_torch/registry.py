"""Dataset registry: label sets, canvas sizes, and custom-dataset hooks.

Parity: reference `src/trainer/trainer/datasets/rico.py:18-68` (label lists)
and `datasets/publaynet.py:13-19`. These are public dataset metadata.

Custom datasets plug in through `register_dataset` (the TPU-native
equivalent of the reference's subclass-`BaseDataset`-and-edit-configs
recipe, `docs/custom_dataset.md:1-40` there; ours is
`docs/custom_dataset.md` here) — no core file needs editing:

    from layoutdm_tpu_torch.registry import register_dataset
    register_dataset("mydata", labels=("a", "b"), canvas=(400, 600),
                     parser=my_parser)

After registration every consumer (configs' `num_categories`, the
ingest/train/sample/eval/render CLIs, visualization canvas lookup) sees
the new name.  `DatasetConfig.register_module` makes the registration
reachable from persisted configs and `key=value` CLIs.

The port's own copy of ``layoutdm_tpu/registry.py``: a dataset registered
here is seen by ``layoutdm_tpu_torch`` only.
"""

from typing import Callable, Dict, Optional, Sequence, Tuple

RICO5_LABELS = (
    "Text",
    "Text Button",
    "Toolbar",
    "Image",
    "Icon",
)

RICO13_LABELS = (
    "Toolbar",
    "Image",
    "Text",
    "Icon",
    "Text Button",
    "Input",
    "List Item",
    "Advertisement",
    "Pager Indicator",
    "Web View",
    "Background Image",
    "Drawer",
    "Modal",
)

RICO25_LABELS = (
    "Text",
    "Image",
    "Icon",
    "Text Button",
    "List Item",
    "Input",
    "Background Image",
    "Card",
    "Web View",
    "Radio Button",
    "Drawer",
    "Checkbox",
    "Advertisement",
    "Modal",
    "Pager Indicator",
    "Slider",
    "On/Off Switch",
    "Button Bar",
    "Toolbar",
    "Number Stepper",
    "Multi-Tab",
    "Date Picker",
    "Map View",
    "Video",
    "Bottom Navigation",
)

PUBLAYNET_LABELS = (
    "text",
    "title",
    "list",
    "table",
    "figure",
)

DATASET_LABELS = {
    "rico5": RICO5_LABELS,
    "rico13": RICO13_LABELS,
    "rico25": RICO25_LABELS,
    "publaynet": PUBLAYNET_LABELS,
}

# canvas aspect ratio (W, H) used for visualization, matching the reference
# renderer defaults (`helpers/visualization.py:66-115` uses H/W from dataset).
DATASET_CANVAS = {
    "rico5": (360, 640),
    "rico13": (360, 640),
    "rico25": (360, 640),
    "publaynet": (612, 792),
}

# custom raw parsers keyed by dataset name (see `register_dataset`);
# built-ins parse through `data/datasets.py` directly.
DATASET_PARSERS: Dict[str, Callable] = {}


def register_dataset(
    name: str,
    labels: Sequence[str],
    canvas: Tuple[int, int] = (360, 640),
    parser: Optional[Callable] = None,
    overwrite: bool = False,
) -> None:
    """Register a custom dataset (docs/custom_dataset.md).

    Args:
      name: dataset key used everywhere (``dataset.name`` in configs,
        CLI ``dataset=<name>``, processed-cache directory
        ``<dir>/<name>-max<S>/processed/{train,val,test}.npz``).
      labels: ordered category names; their count defines the model's
        category vocabulary.
      canvas: (W, H) aspect used by the visualizers.
      parser: optional ``parser(raw_dir, max_seq_length)`` building the
        splits from raw files on first use.  It returns EITHER a dict
        ``{"train": layouts, "val": layouts, "test": layouts}`` OR a flat
        list of layouts — the flat form gets the reference's seeded
        shuffle + 85/5/10 split (`rico.py:160-173` semantics).  Each
        layout is ``(bbox (n,4) f32 center-xywh in [0,1], label (n,)
        int)`` with an optional third provenance-name element.  Omit the
        parser when the data ships as pre-built ``.npz`` splits.
      overwrite: guard against accidental shadowing of built-ins.
    """
    name = str(name)
    if not overwrite and (
        name in DATASET_LABELS and tuple(labels) != DATASET_LABELS[name]
    ):
        raise ValueError(
            f"dataset {name!r} is already registered with different labels;"
            " pass overwrite=True to replace it"
        )
    if name == "synthetic":
        raise ValueError("'synthetic' is reserved for the built-in generator")
    if len(labels) == 0:
        raise ValueError("labels must be non-empty")
    DATASET_LABELS[name] = tuple(str(l) for l in labels)
    DATASET_CANVAS[name] = (int(canvas[0]), int(canvas[1]))
    if parser is not None:
        DATASET_PARSERS[name] = parser


def import_registrations(spec: str) -> None:
    """Import the module whose import-time side effect registers custom
    datasets.  ``spec`` is a dotted module path (``mypkg.mydataset``) or a
    filesystem path to a ``.py`` file — the latter lets a project keep its
    dataset definition next to its data.  Idempotent: re-imports are no-ops
    (module cache / registry overwrite checks)."""
    import importlib
    import importlib.util
    import os
    import sys

    if spec.endswith(".py") or os.path.sep in spec:
        path = os.path.abspath(spec)
        mod_name = "_layoutdm_tpu_torch_custom_" + os.path.splitext(
            os.path.basename(path)
        )[0]
        if mod_name in sys.modules:
            return
        util = importlib.util
        module_spec = util.spec_from_file_location(mod_name, path)
        if module_spec is None or module_spec.loader is None:
            raise ImportError(f"cannot load dataset module from {spec!r}")
        module = util.module_from_spec(module_spec)
        sys.modules[mod_name] = module
        module_spec.loader.exec_module(module)
    else:
        importlib.import_module(spec)
