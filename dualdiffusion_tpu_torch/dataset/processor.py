# Copied from dualdiffusion_tpu/dataset/processor.py; the accelerator stage type is "cuda".
"""Multiprocess dataset factory: a staged worker pipeline (reference:
src/dataset/dataset_processor.py:186-690).

* A chain of ``DatasetProcessStage`` plug-ins joined by ``WorkQueue``s with
  shared progress counters (:186-234).
* A worker pool per stage by stage type: "io" one process, "cuda" one
  process (one card; at most one such stage a pipeline), "cpu" a weighted
  share of ``max_num_proc``.
* Workers start with the spawn method and own what they load: the "cuda"
  worker makes its own CUDA context, and the parent never touches the card
  for it. Their logs go through a queue to the parent, which counts the
  warnings and errors (:127-139, :237-262); each worker logs the seconds
  from its spawn to the end of its ``start_process``.
* A progress monitor thread (the reference uses a tqdm process, :141-169).
* SIGINT-safe shutdown in reverse stage order with sentinel flushing
  (:616-633), and an error and warning summary (:648-668).
* ``test_mode`` (no writes) and ``force_overwrite``.

Stages subclass DatasetProcessStage and implement ``process(item)``; the
optional hooks are ``start_process()`` (per-worker setup, such as loading a
model in the cuda worker), ``finish_process()``, ``stage_type``,
``proc_weight`` and ``summary_banner``.
"""

from __future__ import annotations

import logging
import logging.handlers
import multiprocessing as mp
import os
import signal
import threading
import time
import traceback
from abc import ABC, abstractmethod
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

logger = logging.getLogger(__name__)

_SENTINEL = None


@dataclass
class DatasetProcessorConfig:
    dataset_path: str = ""
    max_num_proc: Optional[int] = None
    force_overwrite: bool = False
    test_mode: bool = False
    verbose: bool = False
    queue_max_size: int = 256
    monitor_interval: float = 2.0


class WorkQueue:
    """A manager queue with shared progress counters (reference :186-234)."""

    def __init__(self, manager, maxsize: int = 0) -> None:
        self.queue = manager.Queue(maxsize or 0)
        self.total_count = manager.Value("i", 0)
        self.processed_count = manager.Value("i", 0)
        self.lock = manager.Lock()

    def put(self, item) -> None:
        self.queue.put(item)
        if item is not _SENTINEL:
            with self.lock:
                self.total_count.value += 1

    def get(self, timeout: Optional[float] = None):
        item = self.queue.get(timeout=timeout)
        if item is not _SENTINEL:
            with self.lock:
                self.processed_count.value += 1
        return item

    def progress(self):
        with self.lock:
            return self.processed_count.value, self.total_count.value


class DatasetProcessStage(ABC):
    """One pipeline stage; instances are pickled into worker processes."""

    stage_type: str = "cpu"       # "io" | "cpu" | "cuda"
    proc_weight: float = 1.0
    limit_output_queue_size: bool = True

    def start_process(self, config: DatasetProcessorConfig, worker_index: int) -> None:
        """Per-worker setup (e.g. the model load of the cuda stage)."""

    def finish_process(self) -> None:
        """Per-worker teardown."""

    @abstractmethod
    def process(self, item: Any) -> Optional[Any]:
        """Process one item; the return value (or each element of a list)
        goes to the next stage; None drops the item."""

    def summary_banner(self, logger: logging.Logger) -> None:
        pass


def _worker_main(stage: DatasetProcessStage, config: DatasetProcessorConfig,
                 worker_index: int, in_q: WorkQueue, out_q: Optional[WorkQueue],
                 log_q, name: str, spawned_at: float) -> None:
    # workers ignore SIGINT; shutdown is driven by sentinels from the parent
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    root = logging.getLogger()
    root.handlers = [logging.handlers.QueueHandler(log_q)]
    root.setLevel(logging.DEBUG if config.verbose else logging.INFO)
    wlog = logging.getLogger(name)
    try:
        stage.start_process(config, worker_index)
        started = True
        wlog.info("%s ready %.2f s after spawn", name, time.time() - spawned_at)
    except Exception:
        wlog.error("start_process failed:\n%s", traceback.format_exc())
        started = False
    try:
        while True:
            item = in_q.get()
            if item is _SENTINEL:
                break
            if not started:     # drain, so that the stage before never blocks
                continue
            try:
                result = stage.process(item)
            except Exception:
                wlog.error("error processing %r:\n%s", _short(item), traceback.format_exc())
                continue
            if result is None or out_q is None:
                continue
            if isinstance(result, list):
                for r in result:
                    out_q.put(r)
            else:
                out_q.put(result)
    finally:
        if started:
            try:
                stage.finish_process()
            except Exception:
                wlog.error("finish_process failed:\n%s", traceback.format_exc())
        if out_q is not None:
            out_q.put(_SENTINEL)


def _short(item) -> str:
    s = repr(item)
    return s if len(s) <= 120 else s[:117] + "..."


class DatasetProcessor:
    def __init__(self, config: Optional[DatasetProcessorConfig] = None) -> None:
        from ..utils import DATASET_PATH
        self.config = config or DatasetProcessorConfig()
        if not self.config.dataset_path:
            self.config.dataset_path = DATASET_PATH or ""

    # ---- input scan (reference utils :224-233) ---------------------------
    def scan_files(self, paths: Sequence[Union[str, Path]],
                   extensions: Optional[Sequence[str]] = None) -> List[str]:
        out: List[str] = []
        for root in paths:
            root = Path(root)
            if root.is_file():
                out.append(str(root))
                continue
            for p in sorted(root.rglob("*")):
                if p.is_file() and (extensions is None or p.suffix.lower() in extensions):
                    out.append(str(p))
        return out

    def _num_procs(self, stages: Sequence[DatasetProcessStage]) -> List[int]:
        max_proc = self.config.max_num_proc or max(os.cpu_count() - 2, 1)
        cpu_stages = [s for s in stages if s.stage_type == "cpu"]
        total_weight = sum(s.proc_weight for s in cpu_stages) or 1.0
        counts = []
        for s in stages:
            if s.stage_type in ("io", "cuda"):
                counts.append(1)  # the cuda stage: one process for the one card
            else:
                counts.append(max(int(max_proc * s.proc_weight / total_weight), 1))
        return counts

    def process(self, process_name: str, stages: Sequence[DatasetProcessStage],
                input: Optional[Union[Sequence[str], List[Any]]] = None,
                input_extensions: Optional[Sequence[str]] = None,
                collect_results: bool = False) -> Dict[str, Any]:
        """Run the staged pipeline to completion. ``input`` is a list of
        scan paths (default: the dataset path) or a pre-built item list.
        Returns {"processed": n, "warnings": n, "errors": n} plus
        "results": [...] with ``collect_results`` (the final stage's outputs,
        drained back to the parent, e.g. for build_splits).
        """
        cuda_stages = [s.__class__.__name__ for s in stages if s.stage_type == "cuda"]
        if len(cuda_stages) > 1:
            raise ValueError(f"more than one accelerator stage: {cuda_stages}")

        manager = mp.get_context("spawn").Manager()
        log_q = manager.Queue()
        records: List[logging.LogRecord] = []

        class Collector(logging.Handler):
            def emit(self, record):
                records.append(record)
                logging.getLogger(f"dataset.{process_name}").handle(record)

        listener = logging.handlers.QueueListener(log_q, Collector())
        listener.start()

        if self.config.force_overwrite and not self.config.test_mode:
            logger.warning("force_overwrite enabled - existing files will be overwritten")
        if self.config.test_mode:
            logger.warning("test mode enabled - no files will be written")

        queues = [WorkQueue(manager, self.config.queue_max_size
                            if s.limit_output_queue_size else 0) for s in stages]
        result_q = WorkQueue(manager) if collect_results else None
        out_queues = queues[1:] + [result_q]

        if input is None or (input and isinstance(input[0], (str, Path))):
            paths = [self.config.dataset_path] if input is None else list(input)
            items = self.scan_files(paths, input_extensions)
        else:
            items = list(input)
        for it in items:
            queues[0].put(it)

        counts = self._num_procs(stages)
        ctx = mp.get_context("spawn")
        pools: List[List[mp.Process]] = []
        t0 = time.time()
        try:
            for i, (stage, n) in enumerate(zip(stages, counts)):
                procs = []
                for w in range(n):
                    p = ctx.Process(target=_worker_main, daemon=True,
                                    args=(stage, self.config, w, queues[i], out_queues[i],
                                          log_q, f"{stage.__class__.__name__}:{w}",
                                          time.time()))
                    p.start()
                    procs.append(p)
                pools.append(procs)

            stop = threading.Event()

            def monitor():
                while not stop.wait(self.config.monitor_interval):
                    parts = []
                    for s, q in zip(stages, queues):
                        done, total = q.progress()
                        parts.append(f"{s.__class__.__name__} {done}/{total}")
                    logger.info("progress: %s", " | ".join(parts))

            mon = threading.Thread(target=monitor, daemon=True)
            mon.start()

            # one sentinel per worker of stage 0; each worker forwards one
            # downstream on exit, topped up where the next pool is larger
            for _ in pools[0]:
                queues[0].put(_SENTINEL)
            for i, procs in enumerate(pools):
                for p in procs:
                    p.join()
                if i + 1 < len(pools):
                    for _ in range(max(len(pools[i + 1]) - len(procs), 0)):
                        out_queues[i].put(_SENTINEL)
            stop.set()
            mon.join(timeout=1)
        except KeyboardInterrupt:
            logger.warning("interrupted - terminating stages in reverse order")
            for procs in reversed(pools):
                for p in procs:
                    p.terminate()
            raise
        finally:
            listener.stop()

        results: List[Any] = []
        if result_q is not None:
            sentinels_left = len(pools[-1])
            while sentinels_left > 0:
                item = result_q.get()
                if item is _SENTINEL:
                    sentinels_left -= 1
                else:
                    results.append(item)
        processed, _ = queues[-1].progress()
        manager.shutdown()

        warnings = [r for r in records if r.levelno == logging.WARNING]
        errors = [r for r in records if r.levelno >= logging.ERROR]
        logger.info("'%s' finished in %.1fs: %d items through final stage, %d warnings, "
                    "%d errors", process_name, time.time() - t0, processed, len(warnings),
                    len(errors))
        for r in errors[:20]:
            logger.error("error summary: %s", r.getMessage()[:500])
        for s in stages:
            s.summary_banner(logger)
        out: Dict[str, Any] = {"processed": processed, "warnings": len(warnings),
                               "errors": len(errors)}
        if result_q is not None:
            out["results"] = results
        return out
