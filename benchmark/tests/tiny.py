"""A benchmark tree of its own for the CPU tests: a tiny-width configuration
and cells defined only in these files, found by the harness by name."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark.spec import ROOT

HOME = ROOT / "benchmark"


def tiny_config(multispeaker: bool) -> dict:
    cfg = json.loads((HOME / "configs" / ("libritts-hifigan.json" if multispeaker
                                          else "ljspeech-istftnet.json")).read_text())
    mp = cfg["model_params"]
    mp.update(hidden_dim=64, style_dim=32, dim_in=16, n_layer=2)
    mp["decoder"].update(upsample_initial_channel=64, resblock_kernel_sizes=[3, 5],
                         resblock_dilation_sizes=[[1, 3, 5], [1, 3, 5]])
    mp["diffusion"]["transformer"].update(num_layers=1, num_heads=2, head_features=16)
    cfg["plbert_params"].update(hidden_size=64, num_attention_heads=4, intermediate_size=128,
                                num_hidden_layers=2, embedding_size=32)
    cfg["name"] = "tiny-ms" if multispeaker else "tiny"
    return cfg


TOKENS = {"dist": "normal", "mean": 24, "sd": 6, "min": 12, "max": 40}
WORKLOADS = {
    "tiny.poisson": ("tiny", {"entry": "http", "load": {"kind": "open", "rate_per_s": 3.0},
                              "server": {"max_batch": 3, "window_ms": 15}, "tokens": TOKENS,
                              "check": {"batches": 3}}),
    "tiny.lowrate": ("tiny", {"entry": "http", "load": {"kind": "open", "rate_per_s": 0.5},
                              "server": {"max_batch": 3, "window_ms": 15}, "tokens": TOKENS,
                              "check": {"batches": 3}}),
    "tiny.single": ("tiny", {"entry": "library", "load": {"kind": "closed", "clients": 1},
                             "requests_per_s": 10, "tokens": TOKENS, "check": {"batches": 3}}),
    "tiny-ms.voices": ("tiny-ms", {"entry": "http", "load": {"kind": "closed", "clients": 4},
                                   "requests_per_s": 20, "server": {"max_batch": 3,
                                                                    "window_ms": 15},
                                   "tokens": TOKENS, "voices": {"count": 3, "zipf_s": 1.0,
                                                                "seconds": 1.5},
                                   "check": {"batches": 3}}),
}


def make_tree(where: Path) -> Path:
    """A checkout-like tree: BENCHMARK.json with the tiny cells, their
    configuration and traffic files and the harness's entries and metric
    readers."""
    home = where / "bench"
    (home / "configs").mkdir(parents=True)
    (home / "workloads").mkdir()
    for d in ("entries", "metrics"):
        shutil.copytree(HOME / d, home / d, ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["paths"] = ["bench"]
    bench["configs"] = []
    for ms in (False, True):
        cfg = tiny_config(ms)
        (home / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": cfg["name"], "source": "tiny widths for the CPU tests",
                                 "file": f"bench/configs/{cfg['name']}.json", "reduced": [],
                                 "why": "CPU tests"})
    bench["workloads"] = []
    for name, (conf, wl) in WORKLOADS.items():
        (home / "workloads" / f"{name}.json").write_text(json.dumps(wl))
        bench["workloads"].append({"name": name, "config": conf, "traffic": name.split(".")[1],
                                   "chips": 1, "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (where / "BENCHMARK.json").write_text(json.dumps(bench))
    return where
