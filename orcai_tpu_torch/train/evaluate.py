"""Model evaluation: confusion tables + misclassification tables.

Counterpart of orcai_tpu/train/evaluate.py, without pandas: a table is an
io/tables.py `Table` of numpy columns whose `to_csv` writes the text that
DataFrame.to_csv writes. Both tables are vectorized one-hot matrix
products over the stacked (rows, labels) matrices:

- confusion table: per-call TP/FN/FP/TN rates + precision/recall/F1 over
  unmasked positions, prediction threshold 0.5, rows sorted by Total
  descending as DataFrame.sort_values orders them;
- misclassification tables (both directions): restricted to rows with at
  most one active label in the source matrix; a source row with one active
  label c1 contributes 1/k to (c1, c2) for each of the k active target
  labels, 1 to (c1, NOLABEL) if none, and is skipped entirely when the
  target is masked at c1; label-free rows attribute from NOLABEL. Rows are
  normalized and rounded to 3 decimals with a fraction_time column.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch

from orcai_tpu_torch.io.dataset import ArrayDataset, epoch_permutation
from orcai_tpu_torch.io.tables import Table
from orcai_tpu_torch.io.model_store import load_orcai_model
from orcai_tpu_torch.native import quantize_linear_native
from orcai_tpu_torch.parallel.mesh import local_devices, mesh_for_batch
from orcai_tpu_torch.utils.device import exact_f32_math
from orcai_tpu_torch.utils.messenger import Messenger
from orcai_tpu_torch.utils.seeds import (
    MASK_VALUE,
    SEED_ID_LOAD_TEST_DATA,
    SEED_ID_LOAD_UNFILTERED_TEST_DATA,
)


def compute_confusion_table(
    y_true_batch: np.ndarray,
    y_pred_batch: np.ndarray,
    label_names: list[str],
) -> Table:
    """Per-call confusion rates over (batch, time, labels) arrays."""
    y_true = np.asarray(y_true_batch)
    y_pred = (np.asarray(y_pred_batch) >= 0.5).astype(int)
    assert y_true.shape == y_pred.shape

    names = ("TP", "FN", "FP", "TN", "PR", "RE", "F1")
    cols: dict[str, list] = {k: [] for k in (*names, "Total")}
    for i in range(len(label_names)):
        t = y_true[..., i].ravel()
        p = y_pred[..., i].ravel()
        mask = t != MASK_VALUE
        t, p = t[mask], p[mask]
        tp = int(np.sum((t == 1) & (p == 1)))
        fn = int(np.sum((t == 1) & (p == 0)))
        fp = int(np.sum((t == 0) & (p == 1)))
        tn = int(np.sum((t == 0) & (p == 0)))
        tot = tp + fn + fp + tn
        row = {
            "TP": tp / tot if tot else np.nan,
            "FN": fn / tot if tot else np.nan,
            "FP": fp / tot if tot else np.nan,
            "TN": tn / tot if tot else np.nan,
            "PR": tp / (tp + fp) if tp + fp > 0 else np.nan,
            "RE": tp / (tp + fn) if tp + fn > 0 else np.nan,
            "F1": 2 * tp / (2 * tp + fp + fn) if tp + fp + fn > 0 else np.nan,
            "Total": tot,
        }
        for k, v in row.items():
            cols[k].append(v)
    table = Table(
        list(label_names),
        {**{k: np.asarray(cols[k], np.float64) for k in names},
         "Total": np.asarray(cols["Total"], np.int64)},
    )
    return table.take(_descending_order(table["Total"]))


def _descending_order(values: np.ndarray) -> np.ndarray:
    """Row order of DataFrame.sort_values(ascending=False): numpy's default
    (unstable) argsort of the reversed column, reversed. Where totals tie,
    the order is whatever that sort leaves on the machine at hand (an
    insertion sort keeps ties in their given order, a vectorized sort need
    not), so these are pandas' own steps and not a stable sort."""
    backwards = np.ascontiguousarray(values)[::-1]
    indexer = np.arange(len(values))[::-1][backwards.argsort(kind="quicksort")]
    return indexer[::-1]


def _attribution_matrix(m1: np.ndarray, m2: np.ndarray, n_labels: int) -> np.ndarray:
    """Vectorized (L+1, L+1) misclassification counts, source m1 -> target m2.

    Row selection (<=1 active label in m1) is assumed done by the caller.
    """
    ones1 = m1 == 1
    ones2 = m2 == 1
    count1 = ones1.sum(axis=1)
    k2 = ones2.sum(axis=1)

    # source one-hot rows (L+1): active label or NOLABEL
    src = np.zeros((m1.shape[0], n_labels + 1))
    single = count1 == 1
    src[single, :n_labels] = ones1[single]
    src[count1 == 0, n_labels] = 1.0

    # rows with one source label are dropped when the target is masked there
    c1_idx = np.argmax(ones1, axis=1)
    masked_at_c1 = m2[np.arange(m1.shape[0]), c1_idx] == MASK_VALUE
    src[single & masked_at_c1] = 0.0

    # target attribution rows: 1/k over active labels, or NOLABEL
    tgt = np.zeros((m1.shape[0], n_labels + 1))
    has2 = k2 > 0
    tgt[has2, :n_labels] = ones2[has2] / k2[has2, None]
    tgt[~has2, n_labels] = 1.0

    return src.T @ tgt


def _misclassification_table(
    m1: np.ndarray,
    m2: np.ndarray,
    suffix_1: str,
    suffix_2: str,
    label_names: list[str],
) -> Table:
    n_labels = len(label_names)
    counts = _attribution_matrix(m1, m2, n_labels)
    row_sum = counts.sum(axis=1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        norm = np.around(counts / row_sum, 3)
        fraction = np.around(row_sum / row_sum.sum(), 5)
    names = [f"{suffix_2}_{x}" for x in label_names] + [f"{suffix_2}_NOLABEL"]
    columns = {name: norm[:, j] for j, name in enumerate(names)}
    columns["fraction_time"] = fraction[:, 0]
    return Table(
        [f"{suffix_1}_{x}" for x in label_names] + [f"{suffix_1}_NOLABEL"], columns
    )


def compute_misclassification_tables(
    label_matrix_1: np.ndarray,
    label_matrix_2: np.ndarray,
    suffix_1: str,
    suffix_2: str,
    label_names: list[str],
) -> dict[str, Table]:
    """Both directional misclassification tables (true->pred, pred->true)."""
    m1 = np.asarray(label_matrix_1)
    m2 = np.asarray(label_matrix_2)
    mask1 = (m1 == 1).sum(axis=1) <= 1
    mask2 = (m2 == 1).sum(axis=1) <= 1
    return {
        f"{suffix_1}_{suffix_2}": _misclassification_table(
            m1[mask1], m2[mask1], suffix_1, suffix_2, label_names
        ),
        f"{suffix_2}_{suffix_1}": _misclassification_table(
            m2[mask2], m1[mask2], suffix_2, suffix_1, label_names
        ),
    }


EVAL_UPLOADS = ("f32", "u16", "u8")
_UPLOAD_SCALE = {"u8": 255.0, "u16": 65535.0}


def resolve_eval_upload(upload: str | None = None) -> str:
    """Byte format for staging the test split into device memory.

    None/'auto' -> the ORCAI_TPU_EVAL_UPLOAD env var if set, else "f32",
    the exact evaluation. "u8" / "u16" quantize the [0, 1] spectrograms on
    the host and dequantize on the device, for a 4x / 2x smaller upload.
    """
    if upload in (None, "auto"):
        upload = os.environ.get("ORCAI_TPU_EVAL_UPLOAD", "auto")
    if upload in (None, "auto"):
        upload = "f32"
    if upload not in EVAL_UPLOADS:
        raise ValueError(
            f"unknown eval upload {upload!r} ({'|'.join(EVAL_UPLOADS)}|auto)"
        )
    return upload


def quantize_eval_upload(x: np.ndarray, upload: str) -> np.ndarray:
    """Host-side encode for resolve_eval_upload's format (the device's
    decode is one multiply by 1 / scale): native/quant.c's one pass where
    the host C library loads, else the numpy chain it is bit-equal to."""
    x = np.asarray(x, np.float32)
    if upload == "f32":
        return x
    dtype = np.uint8 if upload == "u8" else np.uint16
    out = quantize_linear_native(x, dtype)
    if out is not None:
        return out
    scale = _UPLOAD_SCALE[upload]
    buf = np.multiply(x, scale, dtype=np.float32)
    np.rint(buf, out=buf)
    np.clip(buf, 0.0, scale, out=buf)
    return buf.astype(dtype)


def _dequantize(x: torch.Tensor, upload: str) -> torch.Tensor:
    if upload == "f32":
        return x
    return x.float() * (1.0 / _UPLOAD_SCALE[upload])


def batches_per_slab(batch_size: int, snippet_elems: int, slab_bytes: int) -> int:
    """Batches staged per slab. A slab is first gathered on the host as
    float32, whatever the upload's code, so it is sized by those bytes."""
    return max(1, slab_bytes // max(batch_size * snippet_elems * 4, 1))


def _test_model_on_dataset(
    trainer,
    dataset: ArrayDataset,
    batch_size: int,
    seed,
    label_names: list[str],
    dataset_name: str,
    upload: str | None = None,
    msgr: Messenger | None = None,
) -> dict:
    if msgr is None:
        msgr = Messenger(verbosity=0)
    msgr.part(f"Testing model on {dataset_name}")
    upload = resolve_eval_upload(upload)
    device = trainer.device

    # The split is staged into device memory in slabs (one upload each) and
    # each slab runs batch by batch on the device; only the per-batch
    # metrics and the (batches, B, T, L) probabilities come back, once a
    # slab. Batch membership and order are the seeded epoch_permutation
    # draw that dataset.batches makes.
    rows = [
        np.asarray(r)
        for r in epoch_permutation(
            len(dataset), batch_size, seed, 0,
            shuffle=True, drop_remainder=False,
        )
    ]
    snippet_elems = int(np.prod(np.asarray(dataset.x.shape[1:])))
    slab_bytes = int(os.environ.get("ORCAI_TPU_EVAL_SLAB_BYTES", str(512 << 20)))
    per_slab = batches_per_slab(batch_size, snippet_elems, slab_bytes)

    y_true_parts, y_pred_parts = [], []
    losses, correct, total, n_snippets = 0.0, 0.0, 0.0, 0
    for s in range(0, len(rows), per_slab):
        slab_rows = rows[s : s + per_slab]
        idx = np.concatenate(slab_rows)
        x = np.asarray(dataset.x[idx], np.float32)
        y = np.asarray(dataset.y[idx], np.float32)
        # keep the remainder batch: every snippet counts. The short batch
        # is padded to full size (zero inputs, MASK_VALUE labels), so the
        # masked loss and accuracy leave every padded row out of the
        # metrics; padded probabilities are sliced off before the tables.
        pad = batch_size - len(slab_rows[-1])
        if pad:
            x = np.concatenate([x, np.zeros((pad, *x.shape[1:]), x.dtype)])
            y = np.concatenate(
                [y, np.full((pad, *y.shape[1:]), MASK_VALUE, y.dtype)]
            )
        nb = len(slab_rows)
        ys = y.reshape(nb, batch_size, *y.shape[1:])
        xs_dev = torch.from_numpy(
            quantize_eval_upload(x, upload).reshape(nb, batch_size, *x.shape[1:])
        ).to(device)
        ys_dev = torch.from_numpy(ys).to(device)
        outs = [
            trainer.eval_step_probs(_dequantize(xs_dev[b], upload), ys_dev[b])
            for b in range(nb)
        ]
        ms = torch.stack([m for m, _ in outs]).cpu().numpy()
        ps = torch.stack([p for _, p in outs]).cpu().numpy()
        for b, r in enumerate(slab_rows):
            k = len(r)
            # weight each batch's masked-mean loss by its VALID snippet
            # count: the uniform per-batch mean on full batches, and
            # unbiased on the padded remainder batch (a 2-snippet tail must
            # not weigh as much as a full batch)
            losses += ms[b, 0] * k
            correct += ms[b, 1]
            total += ms[b, 2]
            n_snippets += k
            y_pred_parts.append(ps[b, :k])
            y_true_parts.append(ys[b, :k])

    data_metrics = {
        "loss": float(losses / max(n_snippets, 1)),
        "MBA": float(correct / max(total, 1.0)),
    }
    msgr.info(data_metrics)

    y_true = np.concatenate(y_true_parts, axis=0)
    y_pred = np.concatenate(y_pred_parts, axis=0)

    msgr.part(f"Calculating confusion table for {dataset_name}")
    confusion_table = compute_confusion_table(y_true, y_pred, label_names)
    msgr.info(confusion_table)

    y_true_stacked = np.vstack(y_true).astype(int)
    y_pred_stacked = np.vstack((y_pred >= 0.5).astype(int))
    tables = compute_misclassification_tables(
        y_true_stacked, y_pred_stacked, "true", "pred", label_names
    )
    msgr.part("Misclassification tables on dataset:")
    for key, tbl in tables.items():
        msgr.info("\n" + key, indent=1)
        msgr.info(tbl, indent=-1)

    return {
        "dataset": dataset_name,
        "data_metrics": data_metrics,
        "confusion_table": confusion_table,
        "misclassification_tables": tables,
        "n_snippets": n_snippets,
    }


def _save_test_results(results: dict, save_dir: Path, msgr: Messenger | None = None) -> None:
    (msgr or Messenger(verbosity=0)).part("Saving test results")
    name = results["dataset"]
    os.makedirs(save_dir, exist_ok=True)
    with open(save_dir / f"{name}_metrics.json", "w") as f:
        json.dump(results["data_metrics"], f)
    results["confusion_table"].to_csv(
        save_dir / f"{name}_confusion_table.csv", index_label="Label"
    )
    for key, tbl in results["misclassification_tables"].items():
        tbl.to_csv(
            save_dir / f"{name}_misclassification_table_{key}.csv",
            index_label="Label",
        )


def test_model(
    model_dir: Path | str,
    data_dir: Path | str,
    test_unfiltered: bool = True,
    output_dir: Path | str | None = None,
    data_compression: str | None = None,
    verbosity: int = 2,
    msgr: Messenger | None = None,
    device: str | torch.device = "cuda",
) -> Path:
    """Evaluate a trained model on the test (and optional unfiltered test)
    dataset; writes metrics JSON + confusion/misclassification CSVs and
    returns the directory they are in (default <model_dir>/test).

    Each batch is split over the largest number of local_devices(device)
    that divides the batch size (every visible card for "cuda", or a list
    of devices), as the reference's mesh_for_batch splits it; the loss and
    the counts are those of the whole batch."""
    from orcai_tpu_torch.train.trainer import Trainer

    if msgr is None:
        msgr = Messenger(verbosity=verbosity, title="Testing model")
    data_dir = Path(data_dir)
    model_dir = Path(model_dir)
    output_dir = Path(output_dir) if output_dir else model_dir / "test"

    devices = local_devices(device)
    msgr.part("Loading model")
    # on the host first: the batch size decides the devices, the Trainer
    # moves the model to the first
    model, orcai_parameter, _ = load_orcai_model(model_dir, device="cpu")
    mp = orcai_parameter["model"]
    calls = orcai_parameter["calls"]
    devices = mesh_for_batch(mp["batch_size"], devices)
    if len(devices) > 1:
        msgr.info(f"Splitting test batches over {len(devices)} devices")
    trainer = Trainer(model, mp["learning_rate"], device=devices[0], eval_devices=devices)

    splits = [("test_dataset", "test_data", SEED_ID_LOAD_TEST_DATA)]
    if test_unfiltered and (data_dir / "test_unfiltered_dataset").exists():
        splits.append(("test_unfiltered_dataset", "test_unfiltered_dataset",
                       SEED_ID_LOAD_UNFILTERED_TEST_DATA))
    with exact_f32_math():
        for folder, name, seed_id in splits:
            dataset = ArrayDataset.load(data_dir / folder)
            seed = (
                [seed_id, orcai_parameter["seed"]]
                if orcai_parameter["seed"] is not None
                else None
            )
            results = _test_model_on_dataset(
                trainer, dataset, mp["batch_size"], seed, calls, name, msgr=msgr
            )
            _save_test_results(results, output_dir, msgr)
            if name == "test_data":
                msgr.info(f"Saved test results to {output_dir}")
    msgr.success("Model testing completed.")
    return output_dir


test_model.__test__ = False  # an entry point, not a pytest case
