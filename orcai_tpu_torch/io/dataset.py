"""Snippet loading and materialized TVT dataset storage (counterpart of
orcai_tpu/io/dataset.py).

- `SnippetDataLoader` fetches (spectrogram, labels) snippet pairs from the
  zarr stores by row range, downsampling labels by mean+round over
  2**n_filters blocks. Zarr handles are cached per recording.
- `ArrayDataset` is the on-disk format training and evaluation read:
  contiguous .npy shards (optionally gzipped) + meta.json. Uncompressed
  shards are memory-mapped, so an epoch of batches is index math and
  page-cache reads. Batch iteration does a full seeded permutation per
  epoch, drawn with numpy exactly as the reference draws it, so both
  packages see the same batches from the same seed.
"""

from __future__ import annotations

import gzip
import json
import math
import shutil
from pathlib import Path

import numpy as np

from orcai_tpu_torch.io.tables import Table
from orcai_tpu_torch.io.zarrlite import open_zarr
from orcai_tpu_torch.utils.seeds import shuffle_seed_from


def reshape_labels(labels: np.ndarray, n_filters: int) -> np.ndarray:
    """Downsample (T, L) frame labels to the model's output grid.

    Mean over non-overlapping 2**n_filters blocks, rounded half-to-even
    (numpy/TF round semantics); fully masked blocks stay MASK_VALUE.
    """
    down = 2**n_filters
    t, n = labels.shape
    if t % down != 0:
        raise ValueError(
            f"Label rows ({t}) must be divisible by 2**n_filters ({down})."
        )
    averaged = labels.reshape(t // down, down, n).mean(axis=1)
    return np.round(averaged).astype(np.float32)


class SnippetDataLoader:
    """Snippet fetcher over a snippet table (recording_data_dir, row range).

    With shuffle, the rows are permuted as DataFrame.sample(frac=1,
    random_state=rng) permutes them: rng.choice(n, n, replace=False).
    """

    def __init__(self, snippet_table, n_filters: int, shuffle: bool = True,
                 rng: np.random.Generator | None = None):
        if rng is None:
            rng = np.random.default_rng()
        if shuffle:
            n = len(snippet_table)
            snippet_table = snippet_table.take(rng.choice(n, size=n, replace=False))
        self.snippet_table = snippet_table
        self.n_filters = n_filters
        self._stores: dict[str, tuple] = {}

    @classmethod
    def from_csv(cls, path: Path | str, n_filters: int, shuffle: bool = True,
                 rng: np.random.Generator | None = None) -> "SnippetDataLoader":
        return cls(Table.read_csv(path), n_filters, shuffle, rng)

    def _store(self, recording_data_dir: str):
        if recording_data_dir not in self._stores:
            base = Path(recording_data_dir)
            self._stores[recording_data_dir] = (
                open_zarr(base / "spectrogram" / "spectrogram.zarr"),
                open_zarr(base / "labels" / "labels.zarr"),
            )
        return self._stores[recording_data_dir]

    def __len__(self) -> int:
        return len(self.snippet_table)

    def __getitem__(self, index: int) -> tuple[np.ndarray, np.ndarray]:
        table = self.snippet_table
        spec_z, label_z = self._store(str(table["recording_data_dir"][index]))
        start, stop = int(table["row_start"][index]), int(table["row_stop"][index])
        spec = spec_z[start:stop, :][..., None]  # (T, bins, 1)
        labels = reshape_labels(label_z[start:stop, :].astype(np.float32), self.n_filters)
        return spec.astype(np.float32), labels

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class _ShardStack:
    """Lazy row-indexable view over per-shard memmaps (no concatenation).

    Supports the dataset's access patterns: len/shape/nbytes, integer and
    index-array row gathers (sorted or not), and np.asarray for callers that
    genuinely need the materialized array (e.g. a device upload).
    """

    def __init__(self, shards: list[np.ndarray]):
        self.shards = shards
        self.offsets = np.cumsum([0] + [len(s) for s in shards])
        self.shape = (int(self.offsets[-1]), *shards[0].shape[1:])
        self.dtype = shards[0].dtype

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape)) * self.dtype.itemsize

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, idx):
        n = len(self)
        if isinstance(idx, (int, np.integer)):
            idx = int(idx)
            if idx < 0:
                idx += n
            if not 0 <= idx < n:
                raise IndexError(f"index {idx} out of bounds for size {n}")
            s = int(np.searchsorted(self.offsets, idx, "right")) - 1
            return self.shards[s][idx - int(self.offsets[s])]
        if isinstance(idx, slice):
            idx = np.arange(*idx.indices(n))
        idx = np.asarray(idx)
        if idx.dtype == np.bool_:
            # boolean masks would be misread as 0/1 integer indices by
            # searchsorted below; convert to the rows they select
            if idx.shape != (n,):
                raise IndexError(
                    f"boolean mask of shape {idx.shape} does not match "
                    f"dataset length {n}"
                )
            idx = np.flatnonzero(idx)
        idx = np.where(idx < 0, idx + n, idx)
        if idx.size and (idx.min() < 0 or idx.max() >= n):
            raise IndexError(f"index out of bounds for size {n}")
        s = np.searchsorted(self.offsets, idx, "right") - 1
        out = np.empty((len(idx), *self.shape[1:]), self.dtype)
        for shard_i in np.unique(s):
            m = s == shard_i
            out[m] = self.shards[shard_i][idx[m] - self.offsets[shard_i]]
        return out

    def __array__(self, dtype=None, copy=None):
        out = np.concatenate([np.asarray(s) for s in self.shards])
        return out.astype(dtype) if dtype is not None else out


class ArrayDataset:
    """Materialized (X, Y) dataset with sharded .npy storage."""

    def __init__(self, x: np.ndarray, y: np.ndarray):
        assert len(x) == len(y)
        self.x = x
        self.y = y

    def __len__(self) -> int:
        return len(self.x)

    @property
    def spectrogram_shape(self):
        return tuple(self.x.shape[1:])

    @property
    def labels_shape(self):
        return tuple(self.y.shape[1:])

    # -- storage ---------------------------------------------------------------

    @staticmethod
    def save_from_loader(
        loader,
        path: Path | str,
        compression: str | None = None,
        shard_size: int = 2048,
        overwrite: bool = False,
        progress=None,
    ) -> None:
        """Materialize a snippet loader into the on-disk format."""
        path = Path(path)
        if path.exists() and any(path.iterdir()) and not overwrite:
            raise FileExistsError(f"File {path} already exists.")
        if len(loader) == 0:
            # refuse BEFORE clearing: an empty loader must not destroy a
            # previously materialized dataset
            raise ValueError(
                f"Refusing to write an empty dataset to {path}: the snippet "
                "loader produced no samples."
            )
        path.mkdir(parents=True, exist_ok=True)
        # write into a temp subdirectory and swap only after meta.json lands:
        # a loader that raises mid-iteration (or whose __len__ disagrees with
        # its iterator) must not destroy a previous materialization
        tmp = path / ".tmp_write"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        out_dir = tmp

        n = len(loader)
        shards = []
        shard_x, shard_y = [], []
        shard_idx = 0

        def flush():
            nonlocal shard_idx, shard_x, shard_y
            if not shard_x:
                return
            xs = np.stack(shard_x)
            ys = np.stack(shard_y)
            _write_npy(out_dir / f"spectrogram_{shard_idx:05d}.npy", xs, compression)
            _write_npy(out_dir / f"labels_{shard_idx:05d}.npy", ys, compression)
            shards.append(len(xs))
            shard_idx += 1
            shard_x, shard_y = [], []

        iterator = loader
        if progress is not None:
            iterator = progress(loader)
        for spec, labels in iterator:
            shard_x.append(np.asarray(spec, np.float32))
            shard_y.append(np.asarray(labels, np.float32))
            if len(shard_x) >= shard_size:
                flush()
        flush()
        if not shards:
            raise ValueError(
                f"Refusing to write an empty dataset to {path}: the snippet "
                "loader produced no samples."
            )

        sample_x = _read_npy(out_dir / "spectrogram_00000.npy", compression)
        meta = {
            "n": int(n),
            "spectrogram_shape": list(sample_x.shape[1:]),
            "labels_shape": list(
                _read_npy(out_dir / "labels_00000.npy", compression).shape[1:]
            ),
            "shards": shards,
            "compression": compression,
        }
        (out_dir / "meta.json").write_text(json.dumps(meta, indent=2))

        # the new dataset is complete — now clear any previous
        # materialization (leftovers from an earlier run with a different
        # compression/shard count must not shadow the new files) and swap
        # in. Swap invariant: meta.json exists ONLY when every shard it
        # names is in place — the old meta is deleted first and the new one
        # renamed last (iterdir order is filesystem-arbitrary), so a crash
        # anywhere in the window leaves a meta-less directory that load()
        # reports as an incomplete create-tvt-data run, never a meta that
        # points at missing shards.
        (path / "meta.json").unlink(missing_ok=True)
        for old in path.glob("*.npy*"):
            old.unlink()
        for f in sorted(out_dir.iterdir(), key=lambda p: p.name == "meta.json"):
            f.rename(path / f.name)
        out_dir.rmdir()

    @classmethod
    def load(cls, path: Path | str) -> "ArrayDataset":
        path = Path(path)
        meta_path = path / "meta.json"
        if not meta_path.exists():
            raise FileNotFoundError(
                f"No dataset at {path} (missing meta.json). Did "
                "create-tvt-data complete successfully?"
            )
        meta = json.loads(meta_path.read_text())
        if not meta["shards"]:
            raise ValueError(f"Dataset at {path} is empty (no shards).")
        compression = meta.get("compression")
        xs, ys = [], []
        for i in range(len(meta["shards"])):
            xs.append(_read_npy(path / f"spectrogram_{i:05d}.npy", compression))
            ys.append(_read_npy(path / f"labels_{i:05d}.npy", compression))
        if len(xs) == 1:
            return cls(xs[0], ys[0])
        if compression:
            # compressed shards are decompressed into RAM anyway
            return cls(np.concatenate(xs), np.concatenate(ys))
        # keep per-shard memmaps: concatenating would materialize the whole
        # dataset in host RAM, defeating the mmap design this module promises
        return cls(_ShardStack(xs), _ShardStack(ys))

    # -- iteration ---------------------------------------------------------------

    def batches(
        self,
        batch_size: int,
        seed: int | list[int] | None = None,
        shuffle: bool = True,
        drop_remainder: bool = True,
        epoch: int = 0,
        rows=None,
    ):
        """Yield (x, y) numpy batches with a per-epoch seeded permutation;
        `rows` maps each batch's index row before it is read (a process of
        data-parallel training takes its block of it)."""
        for idx in epoch_permutation(
            len(self), batch_size, seed, epoch, shuffle, drop_remainder
        ):
            if rows is not None:
                idx = rows(idx)
            yield self.x[idx], self.y[idx]

    def n_batches(self, batch_size: int, drop_remainder: bool = True) -> int:
        n = len(self)
        return n // batch_size if drop_remainder else math.ceil(n / batch_size)


def epoch_permutation(
    n: int,
    batch_size: int,
    seed: int | list[int] | None,
    epoch: int,
    shuffle: bool = True,
    drop_remainder: bool = True,
) -> np.ndarray:
    """(n_batches, batch_size) index rows for one epoch.

    Seeded per-epoch full permutation; indices sorted within each batch
    (monotone reads on memmaps; batch membership unchanged). Shared between
    the streaming and device-resident training paths so both are
    batch-for-batch identical.
    """
    if shuffle:
        rng = np.random.default_rng(
            shuffle_seed_from(seed) + epoch if seed is not None else None
        )
        order = rng.permutation(n)
    else:
        order = np.arange(n)
    n_batches = n // batch_size if drop_remainder else math.ceil(n / batch_size)
    rows = [
        np.sort(order[b * batch_size : (b + 1) * batch_size])
        for b in range(n_batches)
    ]
    if not drop_remainder and rows and len(rows[-1]) != batch_size:
        # ragged tail batch: return a list (np.stack would raise)
        return [row.astype(np.int32) for row in rows]
    return np.stack(rows).astype(np.int32) if rows else np.zeros(
        (0, batch_size), np.int32
    )


def _write_npy(path: Path, arr: np.ndarray, compression: str | None) -> None:
    if compression and compression.upper() == "GZIP":
        import io as _io

        buf = _io.BytesIO()
        np.save(buf, arr)
        Path(str(path) + ".gz").write_bytes(gzip.compress(buf.getvalue(), 1))
    else:
        np.save(path, arr)


def _read_npy(path: Path, compression: str | None) -> np.ndarray:
    # the compression recorded at write time (meta.json) is authoritative;
    # never silently fall back to a stale sibling of the other flavor
    if compression and compression.upper() == "GZIP":
        import io as _io

        gz = Path(str(path) + ".gz")
        return np.load(_io.BytesIO(gzip.decompress(gz.read_bytes())))
    return np.load(path, mmap_mode="r")


def load_dataset(
    path: Path | str,
    batch_size: int,
    compression: str | None = "GZIP",  # kept for CLI parity; autodetected
    seed: int | list[int] | None = None,
):
    """Load a materialized dataset dir; returns (ArrayDataset, batch iterator fn).

    API analogue of reference io.py:150-184 (load -> shuffle -> batch).
    """
    ds = ArrayDataset.load(path)

    def epoch_batches(epoch: int = 0):
        return ds.batches(batch_size, seed=seed, epoch=epoch)

    return ds, epoch_batches
