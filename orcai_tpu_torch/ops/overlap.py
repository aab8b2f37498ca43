"""Sliding-window CRNN inference with overlap-add, on the device.

Counterpart of orcai_tpu/ops/overlap.py.
Window geometry matches the reference exactly: stride = snippet_len // 2,
output grid = T // 2**n_filters rows, window i writing output rows
[i * shift_out, i * shift_out + out_len), average over overlap counts,
binary threshold 0.5 / max(overlap_count). Windows are cut out of the
device-resident spectrogram, run through the model in batches, and
scatter-added (index_add_) into one output grid whose last row is a trash
row for the padding windows of the last chunk; only that small grid comes
back to the host. A chunk's frame offset into the tensor it is given is
separate from the window index that decides its output rows, so the
streaming path (ops/streaming.py) can hand in one normalized tile at a time.

Dense-trunk inference (opt-in: dense_trunk=True or ORCAI_TPU_DENSE_TRUNK=1)
runs the conv trunk ONCE over slabs of consecutive windows (50%-overlapping
windows compute every trunk frame twice on the windowed path) and windows
only the sequence head's inputs, on the trunk's 16x coarser grid. It is
exact overlap-save: each slab carries a halo of at least the trunk's
receptive-field radius, so interior trunk steps equal a dense trunk over
the whole recording; the numbers differ from the windowed path's only where
a window's zero padding differs from the real neighbouring frames. Off by
default, as in the reference, and never taken by the streaming path.

Several devices (`devices`, a mesh of parallel/mesh.py): each batch of
windows is cut into contiguous blocks, one for a replica of the model on
each device, as the reference shards the window axis over its mesh's
"data" axis; the predictions come back to the first device, where the
spectrogram and the output grid live, so every output row receives the
same contributions as on one device. The batch size is rounded up to a
multiple of the device count and the dense trunk is off, as there.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from orcai_tpu_torch.parallel.mesh import Replicas, shard_batch_size


def _next_pow2(n: int, minimum: int = 4096) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


class WindowPredictor:
    """Batched overlapping-window predictor for one loaded model.

    `model` is a module on the device the spectrograms live on; it maps
    (B, snippet_len, bins, 1) to (B, snippet_len / 2**n_filters, num_labels)
    float32 probabilities, and for the dense trunk takes `trunk_only` and
    `head_input` (models/crnn.py). `devices`, a list of more than one
    device whose first is the model's, splits every batch over them.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        snippet_len: int = 736,
        n_filters: int = 4,
        batch_size: int = 128,
        max_windows_per_chunk: int = 2048,
        dense_trunk: bool | None = None,
        devices=None,
    ):
        self.model = model
        self.device = next(model.parameters()).device
        self.replicas = None
        if devices is not None and len(devices) > 1:
            self.replicas = Replicas(model, devices)
            self.model = self.replicas.models[0]
            self.device = self.replicas.devices[0]
            batch_size = shard_batch_size(batch_size, devices)
        self.batch_size = batch_size
        self.snippet_len = snippet_len
        self.shift = snippet_len // 2
        self.down = 2**n_filters
        # the halves-reshape window extraction assumes snippet_len == 2 *
        # shift, and the overlap-add grid assumes the trunk's downsample
        # divides both
        if snippet_len % (2 * self.down) != 0:
            raise ValueError(
                f"snippet_len {snippet_len} must be divisible by "
                f"2 * 2**n_filters = {2 * self.down} for half-overlap "
                "windowing and the overlap-add output grid"
            )
        self.out_len = snippet_len // self.down
        self.shift_out = self.shift // self.down
        self.max_windows_per_chunk = max(
            self.batch_size,
            max_windows_per_chunk // self.batch_size * self.batch_size,
        )
        if dense_trunk is None:
            dense_trunk = os.environ.get("ORCAI_TPU_DENSE_TRUNK") == "1"
        self.dense_trunk = bool(dense_trunk) and self.replicas is None
        # trunk receptive-field radius in input frames: entry conv (k//2)
        # + per block b: two separable convs (2 * 2^b * (k//2)) + pool3
        # (2^b) + head separable conv (2^n_filters * (k//2)), rounded up to
        # the downsample grid so slab starts stay pool-aligned
        k_half = getattr(model, "kernel_size", 3) // 2
        radius = k_half + sum(
            (2 * k_half + 1) * 2**b for b in range(n_filters)
        ) + self.down * k_half
        self.halo = -(-radius // self.down) * self.down

    def _plan_chunk_size(self, n_win: int) -> int:
        """Windows per chunk: the batch-size multiple covering n_win, rounded
        up a {4, 5, 6} * 2**k batch-count ladder (1,2,3,4,5,6,8,10,12,16,...),
        capped at max_windows_per_chunk (verbatim from the reference, where
        each value is one compiled executable)."""
        bsz = self.batch_size
        n_batches = max(1, -(-n_win // bsz))
        b = 1
        while b < n_batches:
            b *= 2
        if b > 4 and (b * 5) // 8 >= n_batches:
            b = (b * 5) // 8
        elif b > 2 and (b * 3) // 4 >= n_batches:
            b = (b * 3) // 4
        return min(self.max_windows_per_chunk, b * bsz)

    def plan(self, t: int) -> tuple[int, tuple, int, int]:
        """Execution plan for t valid spectrogram frames: (n_win, chunks,
        required_frames, n_out_pad), chunks being (wpc, count) pairs run in
        order: full max_windows_per_chunk chunks, then at most one smaller
        ladder-planned remainder. n_out_pad is the output grid covering every
        chunk's window span, widened by shift_out when the recording's tail
        extends past it, so the [:n_out_total] fetch never reaches the trash
        row."""
        n_win = (t - self.snippet_len) // self.shift + 1
        cap = self.max_windows_per_chunk
        if n_win > cap:
            full, rem = divmod(n_win, cap)
            chunks = [(cap, full)]
            if rem:
                chunks.append((self._plan_chunk_size(rem), 1))
        else:
            chunks = [(self._plan_chunk_size(n_win), 1)]
        planned = sum(w * c for w, c in chunks)
        required = (planned + 1) * self.shift
        n_out_pad = (planned - 1) * self.shift_out + self.out_len
        if t // self.down > n_out_pad:
            n_out_pad += self.shift_out
        return n_win, tuple(chunks), required, n_out_pad

    def plan_signature(self, t: int, src_len: int) -> tuple:
        """(spec buffer length, chunks, n_out_pad) for a recording of t valid
        frames arriving in a (src_len, bins) device buffer: the shapes that
        decide which buffers and chunk sizes the recording runs with
        (tools/warmup.py enumerates their distinct values)."""
        _, chunks, required, n_out_pad = self.plan(t)
        target = _next_pow2(required)
        spec_len = src_len if src_len >= target else target
        return spec_len, chunks, n_out_pad

    def n_labels(self, n_bins: int) -> int:
        """Number of labels the model predicts (n_bins is kept for the
        reference's signature; the module knows its own width)."""
        return int(self.model.num_labels)

    def planned_spec_bytes(self, t: int, n_bins: int, src_len: int) -> int:
        """Device bytes aggregate_device holds for a (src_len, bins) float32
        spectrogram of t valid frames: the source buffer plus the re-padded
        copy _ensure_device makes when the chunk plan's power-of-two span
        exceeds src_len."""
        target = _next_pow2(self.plan(t)[2])
        padded = target if src_len < target else 0
        return (src_len + padded) * n_bins * 4

    def _run_chunk(
        self,
        agg: torch.Tensor,
        count: torch.Tensor,
        spec: torch.Tensor,
        wpc: int,
        f0: int,
        w0: int,
        n_win_valid: int,
    ) -> None:
        """Scatter-add the wpc windows that start at frame f0 of `spec` into
        agg/count (in place) as windows w0, w0 + 1, ... of the recording;
        the chunk's windows >= n_win_valid go to the trash row."""
        n_bins = spec.shape[1]
        chunk = spec[f0 : f0 + (wpc + 1) * self.shift]
        halves = chunk.reshape(wpc + 1, self.shift, n_bins)
        windows = torch.cat([halves[:-1], halves[1:]], dim=1)[..., None]
        bsz = min(self.batch_size, wpc)
        forward = self.model if self.replicas is None else self.replicas
        preds = torch.cat(
            [forward(windows[i : i + bsz]) for i in range(0, wpc, bsz)]
        )
        self._scatter(agg, count, preds, w0, n_win_valid)

    def _scatter(self, agg, count, preds: torch.Tensor, w0: int, n_win_valid: int) -> None:
        """Add the (wpc, out_len, L) predictions of windows w0, w0 + 1, ...
        to their output rows; windows >= n_win_valid go to the trash row."""
        n_out_pad = agg.shape[0] - 1
        wpc, _, n_labels = preds.shape
        win_ids = torch.arange(wpc, device=preds.device)[:, None]
        rows = (w0 + win_ids) * self.shift_out + torch.arange(
            self.out_len, device=preds.device
        )[None, :]
        rows = torch.where(win_ids < n_win_valid, rows, n_out_pad).reshape(-1)
        agg.index_add_(0, rows, preds.reshape(-1, n_labels).float())
        count.index_add_(0, rows, torch.ones_like(rows, dtype=torch.float32))

    def _dense_slab_windows(self, wpc: int) -> int:
        """Windows per trunk slab: bounds the slab's trunk activations (a
        33-window slab at the bundled geometry holds a ~165 MB entry-conv
        activation, a whole 640-window chunk ~2.9 GB) while keeping the
        trunk's saving near 2x: trunk frames per window = (S+1)/S * shift
        + 2*halo/S, about 381 against the windowed path's 736 at S=32.
        Must divide wpc; chunk sizes are batch-size multiples, so 32 works
        whenever 32 | wpc."""
        for s in (32, self.batch_size, wpc):
            if wpc % s == 0:
                return min(s, wpc)
        return wpc

    def _run_chunk_dense(
        self,
        agg: torch.Tensor,
        count: torch.Tensor,
        spec_pad: torch.Tensor,
        wpc: int,
        f0: int,
        w0: int,
        n_win_valid: int,
    ) -> None:
        """Dense-trunk variant of _run_chunk, same scatter-add tail.

        `spec_pad` is the spectrogram with `halo` zero rows on both sides
        (recording edges see zeros, as the windowed path's out-of-range
        frames do): frame f is its row f + halo. Slab i covers S windows
        from frame f0 + i*S*shift and reads halo frames more on each side;
        the trunk runs once over it and the halo-free (S+1)*shift_out trunk
        steps are kept. Head inputs are adjacent step-halves, the halves
        trick of the windowed path on the trunk's grid; the head then runs
        over window batches.
        """
        shift, shift_out = self.shift, self.shift_out
        n_slab = self._dense_slab_windows(wpc)
        slab_len = (n_slab + 1) * shift + 2 * self.halo
        h_steps = self.halo // self.down
        wins = []
        for start in range(f0, f0 + wpc * shift, n_slab * shift):
            slab = spec_pad[start : start + slab_len]
            steps = self.model(slab[None, :, :, None], trunk_only=True)[0]
            steps = steps[h_steps : h_steps + (n_slab + 1) * shift_out]
            halves = steps.reshape(n_slab + 1, shift_out, *steps.shape[1:])
            wins.append(torch.cat([halves[:-1], halves[1:]], dim=1))
        wins = torch.cat(wins)  # (wpc, out_len, F', C)
        bsz = min(self.batch_size, wpc)
        preds = torch.cat(
            [self.model(wins[i : i + bsz], head_input=True) for i in range(0, wpc, bsz)]
        )
        self._scatter(agg, count, preds, w0, n_win_valid)

    def _ensure_device(self, spectrogram, t: int, required: int, n_bins: int):
        """Device tensor of shape (>= required, bins) holding the spectrogram."""
        target = _next_pow2(required)
        if isinstance(spectrogram, np.ndarray):
            padded = np.zeros((target, n_bins), np.float32)
            padded[:t] = spectrogram[:t]
            return torch.from_numpy(padded).to(self.device)
        if spectrogram.shape[0] >= target:
            return spectrogram
        padded = torch.zeros(
            (target, n_bins), dtype=torch.float32, device=spectrogram.device
        )
        padded[: spectrogram.shape[0]] = spectrogram
        return padded

    def _zero_grid(self, n_out_pad: int, n_labels: int):
        """Fresh (agg, count) device buffers with a trash row."""
        return (
            torch.zeros((n_out_pad + 1, n_labels), dtype=torch.float32, device=self.device),
            torch.zeros((n_out_pad + 1,), dtype=torch.float32, device=self.device),
        )

    @torch.inference_mode()
    def aggregate_device(self, spectrogram, n_frames: int | None = None):
        """Spectrogram -> device (prob_sum (n_out_pad+1, L), count) buffers,
        without any device->host transfer. Returns (agg, count, n_out_total).
        """
        t = int(spectrogram.shape[0]) if n_frames is None else int(n_frames)
        n_bins = int(spectrogram.shape[1])
        if t < self.snippet_len:
            raise ValueError(
                f"Recording too short for prediction: {t} spectrogram frames "
                f"< snippet length {self.snippet_len}"
            )
        n_win, chunks, required, n_out_pad = self.plan(t)
        spec = self._ensure_device(spectrogram, t, required, n_bins)
        agg, count = self._zero_grid(n_out_pad, self.n_labels(n_bins))
        run = self._run_chunk
        if self.dense_trunk:
            run = self._run_chunk_dense
            spec = torch.nn.functional.pad(spec, (0, 0, self.halo, self.halo))
        w0 = 0
        for wpc, n_repeat in chunks:
            for _ in range(n_repeat):
                run(agg, count, spec, wpc, w0 * self.shift, w0, min(wpc, n_win - w0))
                w0 += wpc
        return agg, count, t // self.down

    @staticmethod
    def fetch_aggregated(
        agg_dev: torch.Tensor, count_dev: torch.Tensor, n_out_total: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """The recording's sync point -> (averaged probs (T//down, L), count)."""
        agg = agg_dev[:n_out_total].cpu().numpy().copy()
        count = count_dev[:n_out_total].cpu().numpy()
        valid = count > 0
        agg[valid] /= count[valid, None]
        return agg, count

    def aggregate(
        self, spectrogram, n_frames: int | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Spectrogram (host (T, bins) array, or a padded device tensor with
        n_frames valid rows) -> (aggregated (T//down, L), overlap_count):
        averaged sigmoid probabilities per output step."""
        agg_dev, count_dev, n_out_total = self.aggregate_device(
            spectrogram, n_frames
        )
        return self.fetch_aggregated(agg_dev, count_dev, n_out_total)

    @staticmethod
    def binary_predictions(
        aggregated: np.ndarray,
        overlap_count: np.ndarray,
        threshold: float = 0.5,
    ) -> np.ndarray:
        """Binarize averaged probabilities: > threshold / max(overlap)."""
        adjusted = threshold / np.max(overlap_count)
        return (aggregated > adjusted).astype(np.int8)
