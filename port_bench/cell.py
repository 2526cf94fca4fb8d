"""One benchmark cell: its entries in ``BENCHMARK.json``, the files they
name, and what drivers, readers and the check share.

Everything is found by name: the configuration's file (``configs``'
``file``), the traffic mix ``traffic/<traffic>.json``, the driver the mix
names (``drivers/<driver>.py``), the limits of the cell's compared numbers
(``limits/<workload>.json``) and each metric's reader
(``metrics/<name>.py``, else ``metrics/<name up to its first dot>.py``).
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import tempfile
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_spec() -> Dict[str, Any]:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _json(path: Path) -> Dict[str, Any]:
    return json.loads(path.read_text())


def configs_by_name(spec) -> Dict[str, Dict[str, Any]]:
    return {c["name"]: _json(ROOT / c["file"]) for c in spec["configs"]}


def reader(name: str) -> ModuleType:
    """A metric's reader module, by its full name or by its quantity (the
    name up to its first dot)."""
    for stem in (name, name.split(".", 1)[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            mod_name = "port_bench.metrics." + stem.replace(".", "__")
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise FileNotFoundError(f"no reader for metric {name!r} under "
                            f"{HERE / 'metrics'}")


def driver(name: str) -> ModuleType:
    return importlib.import_module(f"port_bench.drivers.{name}")


def derive(seed: int, k: int) -> int:
    """A sub-seed of the run's seed for stream ``k`` (weights, LM, ...)."""
    return (int(seed) + 0x9E3779B9 * int(k)) % (1 << 62)


class Cell:
    """A cell's configuration, mix, seed, device, limits and scratch
    directory; the drivers keep what they build on it."""

    def __init__(self, workload: str, seed: int, device, spec=None,
                 configs=None, mix=None, limits=None):
        spec = load_spec() if spec is None else spec
        w = {x["name"]: x for x in spec["workloads"]}
        if workload not in w:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json: "
                           f"{sorted(w)}")
        self.workload = w[workload]
        self.name = workload
        self.configs = configs_by_name(spec) if configs is None else configs
        self.config = self.configs[self.workload["config"]]
        self.mix = (_json(HERE / "traffic" / f"{self.workload['traffic']}.json")
                    if mix is None else mix)
        lim = HERE / "limits" / f"{workload}.json"
        self.limits = (_json(lim) if lim.exists() else {}) if limits is None \
            else limits
        self.seed = int(seed)
        self.device = device
        self.spec = spec
        self.tmp = Path(tempfile.mkdtemp(prefix="port_bench."))

    def paras(self, name: str) -> SimpleNamespace:
        """The entry points' ``paras``: outputs under the run's scratch
        directory, no checkpoint to load, no console messages."""
        return SimpleNamespace(
            config=name, name=name, seed=self.seed, cpu=self.device.type == "cpu",
            logdir=str(self.tmp / "log"), ckpdir=str(self.tmp / "ckpt"),
            outdir=str(self.tmp / "out"), load=None, njobs=0, no_msg=True,
            amp=False)

    def metrics(self, kind: str) -> List[Dict[str, Any]]:
        """The cell's ``end_to_end`` or ``per_layer`` entries."""
        return [m for m in self.spec[kind]
                if "workloads" not in m or self.name in m["workloads"]]


def tokenizer():
    from end_to_end_asr_pytorch_tpu_torch.utils.text import CharacterTextEncoder
    from .traffic import vocab
    return CharacterTextEncoder(vocab())


def assign(module, weights: Dict[str, Any]) -> None:
    """Copy the benchmark's ``weights`` into ``module``'s parameters; the
    names and shapes must match one to one."""
    import torch
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        raise KeyError(f"the program's leaves differ from the benchmark's: "
                       f"{sorted(set(params) ^ set(weights))[:8]}")
    with torch.no_grad():
        for n, p in params.items():
            w = weights[n]
            if tuple(p.shape) != tuple(w.shape):
                raise ValueError(f"{n}: program {tuple(p.shape)}, benchmark "
                                 f"{tuple(w.shape)}")
            p.copy_(w)


def remove_tree(path: Optional[Path]) -> None:
    import shutil
    if path is not None and os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=True)
