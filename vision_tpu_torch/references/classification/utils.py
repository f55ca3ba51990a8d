"""Training utilities of the recipes (the port's copy of the parts of the
repo's ``references/classification/utils.py`` that the detection and
segmentation trainers use; reference ``references/classification/
utils.py``): ``SmoothedValue``, ``MetricLogger``, and whole-state
checkpoints through ``torch.save`` / ``torch.load``."""

from __future__ import annotations

import datetime
import os
import time
from collections import defaultdict, deque
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["MetricLogger", "SmoothedValue", "load_checkpoint", "save_checkpoint"]


class SmoothedValue:
    """reference ``utils.py:14``: windowed median/avg + global avg."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median,
            avg=self.avg,
            global_avg=self.global_avg,
            max=self.max,
            value=self.value,
        )


class MetricLogger:
    """reference ``utils.py:69``: throughput/ETA logging."""

    def __init__(self, delimiter: str = "\t"):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items()
        )

    def add_meter(self, name: str, meter: SmoothedValue):
        self.meters[name] = meter

    def log_every(self, iterable, print_freq: int, header: str = ""):
        """reference ``utils.py:101``."""
        i = 0
        start_time = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        try:
            total = len(iterable)
        except TypeError:
            total = None
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0:
                if total:
                    eta = datetime.timedelta(
                        seconds=int(iter_time.global_avg * (total - i))
                    )
                    print(
                        f"{header} [{i}/{total}] eta: {eta} {self} "
                        f"time: {iter_time} data: {data_time}",
                        flush=True,
                    )
                else:
                    print(f"{header} [{i}] {self} time: {iter_time}", flush=True)
            i += 1
            end = time.time()
        total_time = time.time() - start_time
        print(
            f"{header} Total time: {datetime.timedelta(seconds=int(total_time))}",
            flush=True,
        )


def save_checkpoint(path: str, state: Dict[str, Any]) -> None:
    """``state`` (state dicts, tensors, numbers) to ``path`` through a
    temporary file, so that a reader never sees half a checkpoint
    (reference ``train.py:374-386``)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, map_location: Optional[Any] = "cpu"
                    ) -> Dict[str, Any]:
    """reference ``train.py:341-351``: the state ``save_checkpoint``
    wrote, its tensors on ``map_location``."""
    return torch.load(os.path.abspath(path), map_location=map_location,
                      weights_only=True)
