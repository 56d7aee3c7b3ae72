"""Training logs: windowed loss averages, the .log file, the args snapshot,
spectrogram images and audio clips.

Counterpart of ``maskcyclegan_vc_tpu/obs/logger.py``: loss averages over a
window of ``steps_per_print`` steps, printed and appended to
``<save_dir>/<name>/<name>.log``; ``train_args.json`` beside it; TensorBoard
scalars, hyperparameters, spectrogram images and audio clips where
``tensorboardX`` (and, for the images, matplotlib; for the clips,
soundfile, or else a wav beside the log) is installed, and nothing of them
where it is not. Metric values may be device tensors: they are buffered as
they are and read in one transfer at the print boundary, so the training
loop does not wait for the device on every step. In a data-parallel run only
rank 0 writes (``parallel.dist.rank``); every other rank's logger does
nothing.
"""

from __future__ import annotations

import io as _io
import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from maskcyclegan_vc_tpu_torch.data.audio_io import write_wav
from maskcyclegan_vc_tpu_torch.parallel.dist import rank


class AverageMeter:
    """Windowed scalar average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value, n: int = 1):
        self.sum += float(value) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(1, self.count)


def to_host(rows: List[Dict[str, object]]) -> List[Dict[str, float]]:
    """Per-step metric dicts of 0-dim tensors or floats -> host floats, with
    one device-to-host transfer for all the tensors."""
    tensors = [v for row in rows for v in row.values() if isinstance(v, torch.Tensor)]
    it = iter(torch.stack([t.float() for t in tensors]).cpu().tolist() if tensors else [])
    return [{k: next(it) if isinstance(v, torch.Tensor) else float(v)
             for k, v in row.items()} for row in rows]


class TrainLogger:
    def __init__(self, save_dir: str, name: str, steps_per_print: int = 100,
                 config: Optional[dict] = None, use_tensorboard: bool = True):
        self.active = rank() == 0
        self.steps_per_print = steps_per_print
        self.meters: Dict[str, AverageMeter] = defaultdict(AverageMeter)
        self.tb = None
        self._t_iter = time.time()
        self._buffer = []  # (batch_size, {name: value}) per step
        if not self.active:
            return
        self.run_dir = os.path.join(save_dir, name)
        os.makedirs(self.run_dir, exist_ok=True)
        self.log_path = os.path.join(self.run_dir, f"{name}.log")
        if config is not None:
            with open(os.path.join(self.run_dir, "train_args.json"), "w") as f:
                json.dump(config, f, indent=4, sort_keys=True, default=str)
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self.tb = SummaryWriter(
                    log_dir=os.path.join(save_dir, "logs", f"{name}_{int(time.time())}"))
        if config is not None and self.tb is not None:
            for k in sorted(config):
                self.tb.add_text(f"hparams/{k}", str(config[k]), 0)

    def write(self, msg: str, console: bool = True) -> None:
        if not self.active:
            return
        if console:
            print(msg, flush=True)
        with open(self.log_path, "a") as f:
            f.write(msg + "\n")

    def _drain(self) -> None:
        for (n, _), vals in zip(self._buffer, to_host([md for _, md in self._buffer])):
            for k, v in vals.items():
                self.meters[k].update(v, n)
        self._buffer.clear()

    def log_iter(self, step: int, epoch: int, metrics: Dict[str, object],
                 batch_size: int = 1) -> None:
        """Buffer one step's metrics; every ``steps_per_print`` steps read the
        window from the device, print its averages and write them."""
        if not self.active:
            return
        self._buffer.append((batch_size, metrics))
        if step % self.steps_per_print or step <= 0:
            return
        self._drain()
        dt = (time.time() - self._t_iter) / max(1, self.steps_per_print)
        self._t_iter = time.time()
        self.write(" ".join([f"[epoch {epoch} step {step}]"]
                            + [f"{k}: {m.avg:.5f}" for k, m in sorted(self.meters.items())]
                            + [f"({dt * 1e3:.1f} ms/it)"]))
        if self.tb is not None:
            for k, m in self.meters.items():
                self.tb.add_scalar(k.replace("_", "/", 1), m.avg, step)
        for m in self.meters.values():
            m.reset()

    @staticmethod
    def _render_mel(mel: np.ndarray) -> Optional[np.ndarray]:
        """A mel (M, T) as an RGB image, or None without matplotlib and PIL."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            import PIL.Image
        except ImportError:
            return None
        fig, ax = plt.subplots(figsize=(6, 3))
        ax.imshow(np.asarray(mel), origin="lower", aspect="auto", cmap="magma")
        ax.set_xlabel("frame")
        ax.set_ylabel("mel bin")
        fig.tight_layout()
        buf = _io.BytesIO()
        fig.savefig(buf, format="png", dpi=80)
        plt.close(fig)
        buf.seek(0)
        return np.asarray(PIL.Image.open(buf).convert("RGB"))

    def log_spectrogram(self, tag: str, mel: np.ndarray, step: int) -> None:
        if self.tb is None:
            return
        img = self._render_mel(mel)
        if img is not None:
            self.tb.add_image(tag, img, step, dataformats="HWC")

    def log_spectrogram_grid(self, mels: Dict[str, np.ndarray], step: int) -> None:
        """The panels in one image, two per row, tagged by their joined names."""
        if self.tb is None:
            return
        imgs = [i for i in (self._render_mel(m) for m in mels.values()) if i is not None]
        if not imgs:
            return
        h = max(i.shape[0] for i in imgs)
        w = max(i.shape[1] for i in imgs)
        padded = []
        for i in imgs:
            canvas = np.full((h, w, 3), 255, np.uint8)
            canvas[:i.shape[0], :i.shape[1]] = i
            padded.append(canvas)
        if len(padded) % 2:
            padded.append(np.full((h, w, 3), 255, np.uint8))
        grid = np.concatenate([np.concatenate(padded[r:r + 2], axis=1)
                               for r in range(0, len(padded), 2)], axis=0)
        self.tb.add_image("-".join(mels), grid, step, dataformats="HWC")

    def log_audio(self, tag: str, audio: np.ndarray, step: int,
                  sample_rate: int = 22050) -> None:
        """A clip to TensorBoard; where tensorboardX cannot encode it (it
        needs ``soundfile``), a ``<tag>_<step>.wav`` beside the log."""
        if self.tb is None:
            return
        try:
            self.tb.add_audio(tag, np.asarray(audio).reshape(-1, 1), step, sample_rate)
        except ImportError:
            write_wav(os.path.join(self.run_dir, f"{tag}_{step}.wav"),
                      np.asarray(audio), sample_rate)

    def close(self) -> None:
        """Flush a partial window, so no step's metrics go unlogged."""
        if self._buffer:
            self._drain()
            self.write(" ".join(["[final]"] + [f"{k}: {m.avg:.5f}"
                                               for k, m in sorted(self.meters.items())]))
        if self.tb is not None:
            self.tb.close()
            self.tb = None
