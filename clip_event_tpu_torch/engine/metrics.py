"""Training metrics & logging (counterpart of `clip_event_tpu/engine/metrics.py`;
reference `SmoothedValue`/`MetricLogger`, `utils.py:18-295`).

The step returns device tensors and the loop converts them to floats only
when it drains a window of steps, so timing needs no per-step device sync.
`ScalarWriter` appends `scalars.jsonl` ({"tag", "value", "step"} per line),
the JAX CLI's plain-file scalar stream, and writes the same scalars to a
TensorBoard event file through tensorboardX (or `torch.utils.tensorboard`)
where one is installed. Under data parallelism the step's losses are
already global (the same on every rank); `synchronize_between_processes`
makes the host-side meters' global averages global too (reference
`utils.py:36-47`).
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import time
from collections import defaultdict, deque
from typing import Dict, Iterable

log = logging.getLogger(__name__)


class SmoothedValue:
    """Windowed + global average meter."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        vals = sorted(self.deque)
        return vals[len(vals) // 2] if vals else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / self.count if self.count else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def synchronize_between_processes(self):
        """All-reduce count and total, so `global_avg` is the global one
        (reference `SmoothedValue.synchronize_between_processes`,
        `utils.py:36-47`). The window stats (median, avg, value) stay
        local, as in the reference."""
        from clip_event_tpu_torch.parallel.collectives import reduce_dict

        t = reduce_dict({"count": float(self.count), "total": self.total}, average=False)
        self.count = int(t["count"])
        self.total = t["total"]

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg, value=self.value,
        )


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for name, value in kwargs.items():
            self.meters[name].update(float(value))

    def synchronize_between_processes(self):
        """Sync every meter's global stats across processes (the host-side
        ones, such as data and iteration time, differ by process). Every
        rank holds the same meters: they are updated from the same steps."""
        for name in sorted(self.meters):
            self.meters[name].synchronize_between_processes()

    def __getattr__(self, name):
        if name in self.meters:
            return self.meters[name]
        raise AttributeError(name)

    def __str__(self):
        return self.delimiter.join(f"{n}: {m}" for n, m in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int, header: str = ""):
        """Yield items while tracking iter/data time and printing progress
        with ETA (`utils.py:243-295`)."""
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        try:
            total = len(iterable)
        except TypeError:
            total = None
        end = time.time()
        for i, obj in enumerate(iterable):
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if print_freq and i % print_freq == 0:
                eta = ""
                if total:
                    eta_s = iter_time.global_avg * (total - i)
                    eta = f"eta: {datetime.timedelta(seconds=int(eta_s))}  "
                count = f"[{i}/{total}]" if total else f"[{i}]"
                log.info("%s %s %s%s  time: %s  data: %s",
                         header, count, eta, str(self), iter_time, data_time)
            end = time.time()


def create_logger(task: str, log_dir: str, level: str = "info", phase: str = "train") -> None:
    """Timestamped log file + console (reference `create_logger`,
    `engine.py:177-200`)."""
    os.makedirs(log_dir, exist_ok=True)
    time_str = time.strftime("%Y-%m-%d-%H-%M")
    head = "%(asctime)-15s:[P:%(process)d]: %(message)s"
    root = logging.getLogger()
    root.setLevel(logging.DEBUG if level == "debug" else logging.INFO)
    for handler in list(root.handlers):
        root.removeHandler(handler)
    for handler in (
        logging.FileHandler(os.path.join(log_dir, f"{task}_{phase}_{time_str}.txt")),
        logging.StreamHandler(),
    ):
        handler.setFormatter(logging.Formatter(head))
        root.addHandler(handler)


class ScalarWriter:
    """Minimal TensorBoard-compatible scalar writer (the JAX package's).

    Prefers tensorboardX, then `torch.utils.tensorboard`, when one is
    installed; always also appends {"tag", "value", "step"} lines to
    `<logdir>/scalars.jsonl`, so runs are inspectable without TensorBoard
    (with neither installed, the jsonl alone is written)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "scalars.jsonl"), "a")
        self._tb = None
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
        if SummaryWriter is not None:
            self._tb = SummaryWriter(logdir)

    def add_scalar(self, tag: str, value: float, step: int):
        self._jsonl.write(json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
