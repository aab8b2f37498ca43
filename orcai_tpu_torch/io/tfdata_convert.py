"""One-shot converter: reference tf.data snapshots -> ArrayDataset shards
(counterpart of orcai_tpu/io/tfdata_convert.py).

Upstream orcAI materializes its TVT datasets with `tf.data.Dataset.save`
(GZIP-compressed snapshot dirs); `python -m orcai_tpu_torch
convert-dataset` reads them once and writes ArrayDataset shards (.npy +
meta.json, io/dataset.py), in place or into an output dir, after which
`train` and `test` run on that dir. The snapshots are read from the files
themselves (io/tfrecord.py): no TensorFlow is needed. The shards written
are byte-equal to the JAX package's.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from orcai_tpu_torch.io.dataset import ArrayDataset
from orcai_tpu_torch.io.tfrecord import DataLossError, TFSnapshot
from orcai_tpu_torch.utils.messenger import Messenger

#: dataset directory names the reference's create_tvt_data may materialize
#: (the unfiltered test split is optional)
TVT_DATASET_NAMES = (
    "train_dataset",
    "val_dataset",
    "test_dataset",
    "test_unfiltered_dataset",
)


def is_tf_snapshot(path: Path | str) -> bool:
    """True when `path` looks like a `tf.data.Dataset.save` snapshot dir
    (the two metadata files tf.data always writes)."""
    path = Path(path)
    return (path / "dataset_spec.pb").exists() and (path / "snapshot.metadata").exists()


def _load_tf_snapshot(path: Path, compression: str | None) -> TFSnapshot:
    """The snapshot at `path`, with "auto" probing the compression.

    The metadata does not record the flag, and a wrong one only shows as a
    DataLossError on the first element read: "auto" reads one element under
    GZIP (the reference's default) and falls back to uncompressed on that
    error alone. Any other error is a real problem and surfaces as itself.
    """
    candidates = [compression] if compression != "auto" else ["GZIP", None]
    last_err: Exception | None = None
    for comp in candidates:
        snapshot = TFSnapshot(path, comp)
        elements = iter(snapshot)
        try:
            next(elements)
            return snapshot
        except StopIteration:
            # a valid snapshot with zero elements: readable, just empty (the
            # materialization refuses empty datasets with its own error)
            return snapshot
        except DataLossError as err:
            last_err = err
        finally:
            elements.close()
    raise ValueError(
        f"Could not read tf.data snapshot at {path} with compression in "
        f"{candidates}: {last_err}"
    )


class _SnapshotLoader:
    """A snapshot as the loader ArrayDataset.save_from_loader reads:
    __len__ and (spectrogram, labels) float32 pairs."""

    def __init__(self, snapshot: TFSnapshot):
        if snapshot.n_components != 2:
            raise ValueError(f"{snapshot.path}: {snapshot.n_components} components per "
                             "element, expected (spectrogram, labels)")
        self.snapshot = snapshot

    def __len__(self) -> int:
        return len(self.snapshot)

    def __iter__(self):
        for spec, labels in self.snapshot:
            if spec.ndim == 2:  # reference stores (T, bins, 1); be lenient
                spec = spec[..., None]
            yield spec, labels


def convert_tf_dataset(
    src: Path | str,
    dst: Path | str | None = None,
    compression: str | None = "auto",
    shard_size: int = 2048,
    overwrite: bool = False,
    msgr: Messenger | None = None,
) -> int:
    """Convert ONE tf.data snapshot dir into ArrayDataset shards.

    `dst` defaults to `src`: the .npy shards and meta.json land beside the
    snapshot files (no name collides, and ArrayDataset reads only meta.json
    and *.npy). Returns the number of samples converted.
    """
    src = Path(src)
    dst = Path(dst) if dst is not None else src
    if not is_tf_snapshot(src):
        raise FileNotFoundError(
            f"{src} is not a tf.data snapshot dir (no dataset_spec.pb / snapshot.metadata)"
        )
    if (dst / "meta.json").exists() and not overwrite:
        raise FileExistsError(
            f"{dst} already holds a converted ArrayDataset (use overwrite=True to redo)"
        )
    loader = _SnapshotLoader(_load_tf_snapshot(src, compression))
    # an in-place conversion writes into a dir that holds the snapshot;
    # save_from_loader's overwrite only clears *.npy and meta.json
    ArrayDataset.save_from_loader(
        loader, dst, compression=None, shard_size=shard_size, overwrite=True
    )
    (msgr or Messenger(verbosity=0)).info(f"{src.name}: {len(loader)} samples -> {dst}")
    return len(loader)


def convert_tvt_datasets(
    tvt_dir: Path | str,
    output_dir: Path | str | None = None,
    compression: str | None = "auto",
    shard_size: int = 2048,
    overwrite: bool = False,
    msgr: Messenger | None = None,
) -> dict[str, int]:
    """Convert every reference-materialized dataset under a TVT dir.

    Converts each `{train,val,test,test_unfiltered}_dataset/` snapshot dir,
    skips (with a warning) a split an earlier run converted unless
    `overwrite`, and carries `dataset_shapes.json` / `call_weights.json`
    over to `output_dir` when one is given; `dataset_shapes.json` is written
    from the converted data where the TVT dir has none. Returns
    {dataset_name: n_samples} for the dirs converted by this call.
    """
    tvt_dir = Path(tvt_dir)
    out_base = Path(output_dir) if output_dir is not None else tvt_dir
    if msgr is None:
        msgr = Messenger(verbosity=0)
    if not tvt_dir.is_dir():
        raise NotADirectoryError(f"tvt_dir does not exist: {tvt_dir}")

    converted: dict[str, int] = {}
    found = 0
    for name in TVT_DATASET_NAMES:
        src = tvt_dir / name
        if not src.is_dir() or not is_tf_snapshot(src):
            continue
        found += 1
        dst = out_base / name
        dst.mkdir(parents=True, exist_ok=True)
        try:
            converted[name] = convert_tf_dataset(
                src, dst, compression=compression, shard_size=shard_size,
                overwrite=overwrite, msgr=msgr,
            )
        except FileExistsError:
            # a split converted by an earlier run is skipped, so an
            # interrupted conversion resumes where it stopped
            msgr.warning(f"{name} already converted at {dst}; skipping "
                         "(use --overwrite to redo)")
    if not found:
        raise FileNotFoundError(
            f"No tf.data snapshot dataset dirs found under {tvt_dir} "
            f"(looked for {', '.join(TVT_DATASET_NAMES)})"
        )
    if out_base != tvt_dir:
        for aux in ("dataset_shapes.json", "call_weights.json"):
            if (tvt_dir / aux).exists():
                shutil.copy2(tvt_dir / aux, out_base / aux)
    shapes_path = out_base / "dataset_shapes.json"
    if not shapes_path.exists():
        first = next((n for n in TVT_DATASET_NAMES if (out_base / n / "meta.json").exists()),
                     None)
        if first is not None:
            ds = ArrayDataset.load(out_base / first)
            shapes_path.write_text(json.dumps({
                "spectrogram": list(ds.spectrogram_shape),
                "labels": list(ds.labels_shape),
            }))
    return converted
