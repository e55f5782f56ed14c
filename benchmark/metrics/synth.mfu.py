"""synth.mfu (%): the FLOPs of the window's answers, each counted at its
own tokens and frames as one request synthesized alone
(`yardstick.FlopModel` on the reference), over the summed host wall of the
calls into the Synthesizer that answered them, over the card's f32 peak
(TF32 off)."""

import numpy as np


def read(run):
    calls = run.calls_in_window()
    if not calls or not run.peak_flops:
        return None
    wall = sum(c["t1"] - c["t0"] for c in calls)
    L = np.concatenate([c["tokens"] for c in calls])
    F = np.concatenate([c["frames"] for c in calls])
    flops = float(run.flops()(L, F).sum())
    return 100.0 * flops / wall / run.peak_flops
