"""BaseSolver: the experiment lifecycle of the JAX package's
``solvers/base.py``: hparas merged over the framework defaults, experiment
name ``<config stem or --name>_sd<seed>``, log and checkpoint directories
(``mode="train"``) or the decode output directory (``mode="test"``),
``verbose`` / ``progress`` / ``write_log``, and the checkpoint format
(``ckpt_format: native | orbax``, checked at start-up).

``write_log`` sends each entry to TensorBoard event files under
``<logdir>/<exp>/`` as the JAX package's tensorboardX writer does
(``utils/tensorboard.py``: a dict of scalars through ``add_scalars``, a
text through ``add_text``, an image array, ``utils/util.feat_to_fig``'s
heatmap, through ``add_figure``), and the scalars and texts also to
``<logdir>/<exp>/log.jsonl``, one JSON object per entry (``{"step",
"name", "value"}``).

``save`` writes the reference layout's torch file (``ckpt_format:
native``, the default; ``utils/torch_ckpt.py``) or a directory in the JAX
package's orbax layout (``orbax``; ``utils/orbax.py``).

Under ``torchrun`` the solver joins the process group
(``parallel/mesh.init``: ``self.rank`` of ``self.world``) and lays it out
as ``model_parallel: M`` asks (``mesh.set_model_parallel``: a ``ValueError``
when M does not divide the world); its loaders take the rows of its data
index (``self.shard``). Only rank 0 prints, logs and writes checkpoints
(``save``, which every rank calls: the split parameters and optimizer
slots are gathered whole first, ``parallel/tp.whole``, and a barrier
follows the write).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Union

import numpy as np

from ..config import merge_hparas
from ..parallel import mesh, tp
from ..utils.device import resolve_device
from ..utils.orbax import save_orbax
from ..utils.tensorboard import SummaryWriter
from ..utils.torch_ckpt import save_checkpoint
from ..utils.util import Timer, human_format


class BaseSolver:
    def __init__(self, config: Dict[str, Any], paras, mode: str = "train"):
        self.config = config
        self.paras = paras
        for k, v in merge_hparas(config.get("hparas", {})).items():
            setattr(self, k, v)
        name = getattr(paras, "name", None) or Path(paras.config).stem
        self.exp_name = f"{name}_sd{paras.seed}"
        self.logdir = Path(paras.logdir) / self.exp_name
        self.ckpdir = Path(paras.ckpdir) / self.exp_name
        if mode == "train":
            self.ckpdir.mkdir(parents=True, exist_ok=True)
            self.logdir.mkdir(parents=True, exist_ok=True)
        else:
            self.outdir = Path(paras.outdir) / self.exp_name
            self.outdir.mkdir(parents=True, exist_ok=True)
        self.device = resolve_device("cpu" if getattr(paras, "cpu", False)
                                     else None)
        self.rank, self.world = mesh.init(self.device)
        self.model_parallel = mesh.set_model_parallel(
            int(config.get("model_parallel", 1))).m
        self.shard = dict(rank=mesh.data_index(), world=mesh.data_size(),
                          multiple=self.world)
        self.params: Dict[str, Any] = {}
        self.split: Dict[str, int] = {}   # tp.shard_module's split leaves
        self.step = 0
        self.tokenizer = None   # load_data sets it
        self.timer = Timer()
        self._log = None
        self._writer = None
        # a typo fails at start-up, not at the first validation's save
        self.ckpt_format = config.get("ckpt_format", "native")
        if self.ckpt_format not in ("native", "orbax"):
            raise ValueError(
                f"ckpt_format {self.ckpt_format!r} (want native|orbax)")

    def quiet(self) -> bool:
        return getattr(self.paras, "no_msg", False) or self.rank != 0

    def verbose(self, msg):
        if not self.quiet():
            for m in (msg if isinstance(msg, list) else [msg]):
                print(f"[INFO] {m}", flush=True)

    def progress(self, msg: str):
        if not self.quiet():
            print(f"[{human_format(self.step)}] {msg}", flush=True)

    @property
    def log(self) -> SummaryWriter:
        """The TensorBoard writer, made at its first use."""
        if self._writer is None:
            self._writer = SummaryWriter(self.logdir,
                                         flush_secs=self.TB_FLUSH_FREQ)
        return self._writer

    def write_log(self, log_name: str,
                  value: Union[Dict[str, float], str, np.ndarray]):
        """A dict of scalars, a text or an (H, W, 3) uint8 image to
        TensorBoard, the first two also as a line of log.jsonl (rank 0
        only)."""
        if self.rank != 0:
            return
        if isinstance(value, dict):
            value = {k: float(v) for k, v in value.items() if v is not None}
            if not value:
                return
            self.log.add_scalars(log_name, value, self.step)
        elif isinstance(value, str):
            self.log.add_text(log_name, value, self.step)
        else:
            self.log.add_figure(log_name, value, self.step)
            return
        if self._log is None:
            self._log = open(self.logdir / "log.jsonl", "a", encoding="utf-8")
        self._log.write(json.dumps({"step": self.step, "name": log_name,
                                    "value": value}) + "\n")
        self._log.flush()

    def save(self, name: str, model, optimizer=None, **kw):
        """The whole tensors to ``<ckpdir>/<name>`` on rank 0, as a torch
        file or an orbax directory (``ckpt_format``); every rank takes part
        in the gather and waits for the write."""
        write = save_orbax if self.ckpt_format == "orbax" else save_checkpoint
        with tp.whole(self.params, self.split, optimizer):
            if self.rank == 0:
                write(self.ckpdir / name, model, optimizer=optimizer, **kw)
        mesh.barrier()

    def parallel_msg(self) -> str:
        """`` | tensor parallel DxM`` under tensor parallelism, else ""."""
        m = self.model_parallel
        return (f" | tensor parallel {self.world // m}x{m}" if m > 1
                else "")

    def close(self):
        if self._log is not None:
            self._log.close()
            self._log = None
        if self._writer is not None:
            self._writer.close()
            self._writer = None

    def load_data(self):
        raise NotImplementedError

    def set_model(self):
        raise NotImplementedError

    def exec(self):
        raise NotImplementedError
