"""One run of one cell: set-up, the measured window, the traced stretch, the check.

Everything a cell is made of is found by name: ``BENCHMARK.json`` names the
cell's configuration (``configs/<config>.json``, which names its reference,
``reference/<reference>.py``) and traffic mix (``traffic/<traffic>.json``, whose
``generator`` is ``traffic/<generator>.py``, whose ``KIND`` names the driver,
``drivers/<KIND>.py``); its end-to-end metrics are ``end_to_end/<name>.py`` and
its per-layer metrics ``metrics/<name>.py``, each a reader with its unit; its
correctness limits are ``limits/<cell>.json``.

A driver runs the program (``self_attention_tacotron_torch``) through its own
entry points (``drivers/synthesis.py``: ``synthesis.make_predict_fn`` ->
``predict``; ``drivers/training.py``: ``Trainer.train_step``). Loops are
closed: one client sends its next request or step when the last one has
returned (outputs complete on the card and the lanes' lengths on the host; a
step synchronised).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import random
import sys
import time
import types
from typing import Dict, List, Optional

import numpy as np
import torch

from port_bench import check, trace
from port_bench.traffic import text

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BANNED = ("jax", "jaxlib", "flax", "orbax", "self_attention_tacotron_tpu")
TRACE_SECONDS = 3.0      # the stretch profiled for the device's activity, at most
NAMING_SECONDS = 1.0     # the stretch profiled with the host's operations, at most
EXTRA_SAMPLES = 8        # encode_ms, postnet_ms and the step marks: calls timed after the window


def load_json(*parts: str) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_reader(folder: str, name: str) -> types.ModuleType:
    """``port_bench/<folder>/<name>.py`` (names may hold dots)."""
    path = os.path.join(HERE, folder, name + ".py")
    spec = importlib.util.spec_from_file_location(f"port_bench.{folder}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def banned_modules() -> List[str]:
    """Loaded modules whose whole top-level name is JAX's, flax's, orbax's or the
    JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in BANNED)


class Cell:
    """The pieces of one cell, found by name."""

    def __init__(self, bench: Dict, name: str, config: Optional[Dict] = None,
                 traffic: Optional[Dict] = None, limits: Optional[Dict] = None):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(cells)}")
        self.name = name
        self.spec = cells[name]
        self.config = config or load_json(HERE, "configs", self.spec["config"] + ".json")
        self.traffic = traffic or load_json(HERE, "traffic", self.spec["traffic"] + ".json")
        self.limits = limits if limits is not None else load_json(HERE, "limits", name + ".json")
        self.generator = importlib.import_module(f"port_bench.traffic.{self.traffic['generator']}")
        self.driver = importlib.import_module(f"port_bench.drivers.{self.generator.KIND}").Driver
        self.reference = check.reference(self.config)
        self.hp = self.config["hparams"]
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name] if m["moves"] in moved else [])]


def seeded_weights(cell: Cell, seed: int, device) -> Dict[str, np.ndarray]:
    """The configuration's weights as flat arrays: the committed npz, or drawn
    from the run's seed on the device."""
    spec = cell.config["weights"]
    if "npz" in spec:
        with np.load(os.path.join(ROOT, spec["npz"])) as archive:
            return {k: archive[k] for k in archive.files}
    return cell.reference.draw_flat(cell.hp, text.seed_of(seed, 7), device)


def program_network(cell: Cell, flat: Dict[str, np.ndarray], device):
    from self_attention_tacotron_torch import convert
    from self_attention_tacotron_torch.hparams import HParams
    from self_attention_tacotron_torch.models.models import TacotronNetwork

    hp = HParams().override_from_dict(dict(cell.hp))
    net = TacotronNetwork(hp)
    convert.load_state(net, convert.flax_to_torch_state(flat, hp, net))
    return hp, net.to(device).eval()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Reservoir:
    """A sample of ``size`` served requests drawn from the run's seed, and the
    request with the most frames."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng = size, random.Random(text.seed_of(seed, 8))
        self.items: List[Dict] = []
        self.seen = 0
        self.longest: Optional[Dict] = None

    def offer(self, item: Dict) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            at = self.rng.randrange(self.seen)
            if at < self.size:
                self.items[at] = item
        if self.longest is None or item["frames"] > self.longest["frames"]:
            self.longest = item

    def sample(self) -> List[Dict]:
        out = list(self.items)
        if self.longest is not None and all(x is not self.longest for x in out):
            out.append(self.longest)
        return out


class Span:
    """Device time between marks: CUDA events at ``Trainer.train_step``'s marks
    (``forward``, ``backward``, ``optimizer``) or around a call; the host's clock
    on the CPU, where a test drives the harness."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.names: List[str] = []
        self.stamps = [self._stamp()]

    def _stamp(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def __call__(self, name: str) -> None:
        self.names.append(name)
        self.stamps.append(self._stamp())

    def ms(self) -> Dict[str, float]:
        if self.cuda:
            self.stamps[-1].synchronize()
            return {n: a.elapsed_time(b)
                    for n, a, b in zip(self.names, self.stamps[:-1], self.stamps[1:])}
        return {n: 1e3 * (b - a) for n, a, b in zip(self.names, self.stamps[:-1], self.stamps[1:])}


def closed_loop(driver, first: int, seconds: float) -> Dict:
    """Requests or steps back to back for ``seconds``; the window runs from the
    first call to the return of the last one started within it."""
    items = []
    k = first
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        t0 = time.perf_counter()
        item = driver.serve(k)
        item["start"], item["end"] = t0, time.perf_counter()
        driver.keep(item)
        # the window's record holds no tensor: only the kept sample holds outputs
        items.append({key: item[key] for key in ("start", "end", "frames", "lanes")})
        k += 1
    return {"items": items, "start": start, "end": items[-1]["end"], "next": k}


def lanes(window: Dict) -> List:
    """Each request's or step's lanes, (source length, decoder steps) per lane."""
    return [it["lanes"] for it in window["items"]]


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device="cuda",
             started: Optional[float] = None, control: bool = False,
             readings: bool = False) -> Dict:
    """One run; returns the result line's dictionary; with ``readings`` also every
    number the check computed (``readings``) and, with ``control``, the control's
    (``control``)."""
    started = time.perf_counter() if started is None else started
    kind = cell.generator.KIND
    driver = cell.driver(cell, seed, device)
    first = driver.warm_up()
    sync(device)
    setup_s = time.perf_counter() - started
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        segments = torch.cuda.memory_stats().get("segment.all.allocated", 0)

    metrics: Dict[str, Dict] = {}
    breakdown = None
    busy = None
    if not traced:
        window = closed_loop(driver, first, seconds)
        window["setup_s"] = setup_s
        for m in cell.end_to_end:
            value = load_reader("end_to_end", m["name"]).read(window)
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        attempted = len(window["items"])
    else:
        plain = closed_loop(driver, first, seconds / 2)
        profiled, named = {}, {}
        reduced = trace.profile(lambda: profiled.update(
            closed_loop(driver, plain["next"], min(seconds / 2, TRACE_SECONDS))))
        naming = trace.profile(lambda: named.update(
            closed_loop(driver, profiled["next"], NAMING_SECONDS)), host=True)
        for what, w in (("untraced", plain), ("device traced", profiled),
                        ("host and device traced", named)):
            print(f"{what}: {len(w['items'])} calls in {w['end'] - w['start']!r} s",
                  file=sys.stderr)
        ctx = types.SimpleNamespace(
            hp=cell.hp, dtype=cell.hp["compute_dtype"], kind=kind, trace=reduced,
            plain={"seconds": plain["end"] - plain["start"], "lanes": lanes(plain)},
            profiled={"lanes": lanes(profiled)}, encode_ms=[], postnet_ms=[], marks=[])
        vars(ctx).update(driver.samples(named["next"], EXTRA_SAMPLES))
        for m in cell.per_layer:
            value = load_reader("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        busy = reduced["busy_s"], reduced["window_s"]
        breakdown = {"device_ops": trace.device_ops(reduced), "idle_gaps": trace.idle_gaps(naming)}
        attempted = len(plain["items"]) + len(profiled["items"]) + len(named["items"])

    device_info = {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu",
                   "count": int(cell.spec["chips"]),
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
                   if torch.cuda.is_available() else 0}
    if busy is not None:
        device_info["busy_s"], device_info["window_s"] = busy
    if cuda:
        grown = torch.cuda.memory_stats().get("segment.all.allocated", 0) - segments
        print(f"allocator segments allocated in the window: {grown}", file=sys.stderr)
    driver.release()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    compared = driver.readings(control)
    checks = check.judge(compared["program"], cell.limits)
    result = {"correct": check.passed(checks), "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if readings or control:
        result["control"] = compared.get("control")
        result["readings"] = compared["program"]
        result["left_out"] = compared.get("left_out")
    result["checks"] = checks
    return result

