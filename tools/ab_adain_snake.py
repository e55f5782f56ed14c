"""A/B of the fused AdaIN+snake kernels (K1, K2) against an earlier version of them, on one GPU.

    python3 tools/ab_adain_snake.py --old-py OLD.py --old-cu OLD.cu \
        [--json ab_adain_snake.json]

OLD.py and OLD.cu are an earlier `styletts2_tpu_torch/ops/adain_snake.py`
and `styletts2_tpu_torch/csrc/adain_snake.cu`, e.g. from `git show
<commit>:<path>` into the git-ignored `_archive/`: the old wrapper module
is loaded with its SOURCE pointed at OLD.cu, and builds it with nvcc at
first use. At every main-path shape of chip_smoke.py (K1: KERNEL_CASES with
T >= 4000; K2: the training shapes of BWD_CASES), f32, it checks both
versions against the plain one and times, in turns plain, old, new, new,
old, plain: on the card (chip_smoke.graph_ms: many calls in one CUDA graph)
cold (inputs rotated over 3x the L2, chip_smoke.rotation) and warm (one
input), and per eager call, warm (the host's launch included, as the
synthesis path pays it). Each card time stands beside the bound
(chip_smoke.bound_ms) and its share of it. Then, in turns old, new, new,
old, the host's time per eager call: the wrappers' Python and the launch,
whatever the card takes. Needs a CUDA device.
"""

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from chip_smoke import (BWD_CASES, KERNEL_CASES, _close, _turns, bound_ms, kernel_inputs,  # noqa: E402
                        rotation)
from styletts2_tpu_torch.ops import adain_snake as op  # noqa: E402


def old_op(py: Path, cu: Path):
    """The earlier wrapper module, building and loading the earlier source."""
    spec = importlib.util.spec_from_file_location("adain_snake_old", py)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.SOURCE, mod.BUILD_DIR = cu.resolve(), op.BUILD_DIR
    return mod


def host_ms(fn, sets, iters=200):
    """Host ms per eager call of fn(*args), args taken in turn from `sets`:
    the calls issued with no sync between them (the card's queue holds
    them), so that the time is the wrapper's and the launch's on the host."""
    for i in range(3):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t * 1e3 / iters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--old-py", required=True, type=Path, help="the earlier ops/adain_snake.py")
    ap.add_argument("--old-cu", required=True, type=Path, help="the earlier csrc/adain_snake.cu")
    ap.add_argument("--json", type=Path, help="where to write the results")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    old = old_op(args.old_py, args.old_cu)
    g = torch.Generator(dev).manual_seed(0)
    rows = []
    cases = [(s, False) for s, dt in KERNEL_CASES if dt == "float32" and s[2] >= 4000]
    cases += [(s, True) for s, dt in BWD_CASES if dt == "float32" and s[0] == 16]
    for shape, backward in cases:
        inputs = kernel_inputs(g, dev, shape, torch.float32, with_dy=backward)
        if backward:
            fns = (op.adain_snake_bwd_ref, old.adain_snake_bwd, op.adain_snake_bwd)
        else:
            fns = (op.adain_snake_ref, old.adain_snake, op.adain_snake)
        with torch.inference_mode():
            want = fns[0](*inputs)
            for fn in fns[1:]:
                got = fn(*inputs)
                torch.cuda.synchronize()
                for k, w in zip(got, want) if backward else [(got, want)]:
                    _close(k, w, torch.float32)
            nbytes = (2 if backward else 1) * inputs[0].numel() * 4
            iters = 10 if backward else (100 if inputs[0].numel() < 10 ** 7 else 40)
            cold = _turns(fns, rotation(inputs, nbytes), iters)
            warm = _turns(fns, [inputs], iters)
            eager = _turns(fns, [inputs], iters, graph=False)
            host = [host_ms(f, [inputs]) for f in (fns[1], fns[2], fns[2], fns[1])]
        bound = bound_ms(shape, "float32", backward)
        row = {"kernel": "K2" if backward else "K1", "shape": list(shape), "bound_ms": bound,
               "plan": op.plan_of(inputs[0], backward)._asdict(),
               "device": smi}
        for name, c, w, e in zip(("plain", "old", "new"), cold, warm, eager):
            row[name] = {"cold_ms": list(c), "warm_ms": list(w), "eager_ms": list(e)}
        row["old"]["host_ms"], row["new"]["host_ms"] = [host[0], host[3]], [host[1], host[2]]
        rows.append(row)
        oc, nc = sum(row["old"]["cold_ms"]) / 2, sum(row["new"]["cold_ms"]) / 2
        print(f"{row['kernel']} {shape}: bound {bound:.4f} ms; cold old {oc:.4f} new {nc:.4f} ms "
              f"({oc / nc:.2f}x; share of bound old {bound / oc:.0%} new {bound / nc:.0%}); "
              + "; ".join(f"{n} cold {row[n]['cold_ms'][0]:.4f}/{row[n]['cold_ms'][1]:.4f} warm "
                          f"{row[n]['warm_ms'][0]:.4f}/{row[n]['warm_ms'][1]:.4f} eager "
                          f"{row[n]['eager_ms'][0]:.4f}/{row[n]['eager_ms'][1]:.4f}"
                          for n in ("plain", "old", "new"))
              + f"; host ms per eager call old {host[0]:.4f}/{host[3]:.4f} new "
                f"{host[1]:.4f}/{host[2]:.4f} [{smi}]", flush=True)
        del inputs, want, got
        torch.cuda.empty_cache()
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
