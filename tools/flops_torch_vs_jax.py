"""The port's FLOP count of a training step against XLA's, on the CPU.

    python3 tools/flops_torch_vs_jax.py [--stage first|second]

Runs the JAX bench (`bench_train.py`, XLA's `cost_analysis()` of the
compiled step) and the port's (`python -m styletts2_tpu_torch.bench_train
--device cpu`, `FlopCounterMode` with the RNN formulas) on the same tiny
setup and batch (`parallel/tiny.py`: batch 2, seeded weights,
`synthetic_batch(default_rng(0))`), one timed step each, and prints both
`flops_per_step` and their ratio. XLA also counts elementwise work, FFTs
and reductions, which the port's counter leaves out; the port counts the
fused LSTMs by formula. The JAX side compiles the step: ~4 minutes here.
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def flops(cmd, env) -> float:
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, check=True)
    return float(json.loads(out.stdout.strip().splitlines()[-1])["flops_per_step"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stage", choices=("first", "second"), default="first")
    args = ap.parse_args(argv)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    step = ["--stage", args.stage, "--steps", "1"]
    xla = flops([sys.executable, "bench_train.py", *step], env)
    port = flops([sys.executable, "-m", "styletts2_tpu_torch.bench_train", "--device", "cpu",
                  *step], env)
    print(json.dumps({"stage": args.stage, "xla_flops_per_step": xla,
                      "port_flops_per_step": port, "port_over_xla": port / xla}))


if __name__ == "__main__":
    main()
