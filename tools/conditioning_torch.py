"""How far a 1e-7 relative change of the weights moves each module's
gradient in `chip_smoke.py`'s reduced-width stage-2 reference step (phases
14 and 19), on the CPU or on the card: the conditioning that bounds any
card-vs-CPU comparison of the step; and where the card departs from the CPU
in the step's SLM pass.

    python3 tools/conditioning_torch.py [--source noise|zero|sines] [--istftnet]
        [--seed 5 [6 ...]] [--threads N] [--device cpu|cuda] [--deterministic] [--bisect]

The step is phase 19's (multispeaker, HiFi-GAN; `--istftnet`: phase 14's,
its source as phase 14 runs it): the same weights, batch, clip starts and
host draws. `--source` picks the HiFi-GAN source: `noise` (the sines
zeroed and the noise kept, as phase 19 runs it), `zero` (the whole source
zeroed: a constant excitation, whose instance norms then normalise
rounding) or `sines` (the live source). `--seed` draws the change of the
weights (several seeds: one line block each). `--threads N` changes no
weight and reruns the step on N CPU threads instead of 4: the movement that
the order of the sums alone makes. `--device cuda` runs the step on the
card (TF32 off, as the entry points set it). It prints each module's
relative L2 movement.

`--deterministic` (card): the step twice with cuDNN's default algorithms
and twice with `torch.backends.cudnn.deterministic = True`: each pair's
movement, the two settings against each other and each against the CPU.

`--bisect` (card): the SLM pass (`Stage2Trainer.slm_generator_loss`, the
part of the step whose predictor gradient departs most) cut at its modules,
in its order: PL-BERT and bert_encoder, the diffusion sampler, the
predictor's `encode_texts` and `duration`, `soft_alignment`, the text
encoder, the two `@ attn` products, `F0Ntrain`, the decoder (K1 on the
card), `resample_24k_to_16k`, WavLM, the WavLM discriminator `wd` and the
loss. The CPU runs the pass once, recording each module's inputs, its draws'
generator state and the gradient that reaches its outputs; each module then
runs alone on the card from the CPU's inputs and output gradient, and its
outputs, input gradients and weight gradients are held against the CPU's
(relative L2). Beside each: the module's own movement on the CPU under a
1e-7 relative change of its weights and its inputs (`--seed`'s first).
CPU: ~20 s a step; the card: ~1 min with --deterministic and --bisect.
"""

import argparse
import contextlib
import copy
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def _rel(a, b) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / b.norm()) if b.norm() > 0 else float((a - b).norm())


def _perturb(models, seed):
    """The models' weights times (1 + 1e-7 N(0, 1)), drawn from `seed`, in place."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in models.parameters():
            p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=g).to(p.device))


# ---------------------------------------------------------------------------
# the SLM pass cut at its modules


@contextlib.contextmanager
def _draws(gen, source):
    """Every torch.rand / torch.randn from the CPU generator `gen`, moved to
    the device asked for, and the NSF source as `cs._host_draws` sets it."""
    import styletts2_tpu_torch.models.decoder_istft as pdi

    rand, randn, magphase, sines = torch.rand, torch.randn, pdi.stft_magphase, pdi.SineGen.forward

    def draw(f):
        return lambda size, generator=None, device=None, dtype=None: f(
            size, generator=gen, dtype=dtype).to(device)

    torch.rand, torch.randn, pdi.stft_magphase = draw(rand), draw(randn), cs._zero_phase(magphase)
    pdi.SineGen.forward = {"noise": cs._noise_source, "zero": cs._zero_sines,
                           "sines": sines}[source]
    try:
        yield
    finally:
        torch.rand, torch.randn, pdi.stft_magphase = rand, randn, magphase
        pdi.SineGen.forward = sines


def _slm_stages(num_steps=3, sigma_data=0.2):
    """The SLM pass (`slm_generator_loss`, use_ind False) as (name, fn,
    input names): fn(trainer, **inputs) -> a dict of its outputs (OUTPUTS)."""
    from styletts2_tpu_torch import losses as L
    from styletts2_tpu_torch.models.diffusion.denoiser import draw_embedding_mask
    from styletts2_tpu_torch.models.wavlm import resample_24k_to_16k
    from styletts2_tpu_torch.parallel import ddp
    from styletts2_tpu_torch.train.mp import run
    from styletts2_tpu_torch.train.stage1 import clip_slice
    from styletts2_tpu_torch.train.stage2 import soft_alignment

    def bert(tr, ref_tokens, ref_lengths):
        bert_dur, d_en = tr._bert(ref_tokens, ref_lengths)
        return {"bert_dur": bert_dur, "d_en": d_en}

    def sampler(tr, bert_dur, feats):
        proba = tr.cfg.model_params.diffusion.embedding_mask_proba
        mask = draw_embedding_mask(len(bert_dur), proba, None, bert_dur.device)
        return {"s_preds": tr._sample_style(bert_dur, feats, num_steps, sigma_data, mask, None)}

    def predictor(tr, d_en, s_preds, ref_lengths):
        p, sd = tr.models["predictor"], tr.cfg.model_params.style_dim
        d = p.encode_texts(d_en, s_preds[:, sd:], ref_lengths)
        return {"d": d, "dur_logits": p.duration(d, ref_lengths)}

    def alignment(tr, dur_logits, ref_lengths):
        attn, total = soft_alignment(dur_logits, ref_lengths, tr.slm_frames()[1],
                                     tr.cfg.slmadv_params.sig)
        return {"attn": attn, "total": total}

    def text_encoder(tr, ref_tokens, ref_lengths):
        with torch.no_grad():
            return {"t_en": tr.models["text_encoder"](ref_tokens, ref_lengths)}

    def products(tr, t_en, d, attn):
        return {"asr_pred": t_en @ attn, "p_pred": d.transpose(1, 2) @ attn}

    def f0n(tr, p_pred, s_preds, total, mel_lengths):
        slm_clip, slm_frames = tr.slm_frames()
        sd = tr.cfg.model_params.style_dim
        valid = (total > slm_clip) & (mel_lengths // 2 > slm_clip)
        max_start = torch.clamp(torch.clamp(total, max=slm_frames) - slm_clip, min=1)
        starts = (torch.rand((len(total),), device=total.device) * max_start).long()
        f0, n = tr.models["predictor"].F0Ntrain(clip_slice(p_pred, starts.tolist(), slm_clip),
                                                s_preds[:, sd:])
        return {"f0": f0, "n": n, "starts": starts, "valid": valid}

    def decoder(tr, asr_pred, starts, f0, n, s_preds):
        sd = tr.cfg.model_params.style_dim
        tr.models["decoder"].eval()
        return {"y_pred": run(tr.models, "decoder", tr.mp,
                              clip_slice(asr_pred, starts.tolist(), tr.slm_frames()[0]), f0, n,
                              s_preds[:, :sd], None)}

    def resample(tr, y_pred):
        return {"y16": resample_24k_to_16k(y_pred)}

    def wavlm(tr, y16):
        return {"states": L.stack_wavlm_states(run(tr.models, "wavlm", tr.mp, y16))}

    def wd(tr, states):
        return {"d_g": tr.models["wd"](states)}

    def loss(tr, d_g, valid):
        w = valid.float()[:, None]
        return {"loss": ddp.global_sum((((1.0 - d_g) ** 2) * w).sum()) / torch.clamp(
            ddp.global_sum(w.sum()) * d_g.shape[1], min=1.0)}

    stages = [("PL-BERT + bert_encoder", bert), ("diffusion sampler", sampler),
              ("predictor.encode_texts + duration", predictor), ("soft_alignment", alignment),
              ("text_encoder", text_encoder), ("@ attn products", products), ("F0Ntrain", f0n),
              ("decoder", decoder), ("resample_24k_to_16k", resample), ("WavLM", wavlm),
              ("wd", wd), ("loss", loss)]
    return [(name, fn, fn.__code__.co_varnames[1:fn.__code__.co_argcount]) for name, fn in stages]


def _run_stage(tr, fn, inputs, grad_outs, gen_state, source):
    """One module of the pass on `tr`'s device from `inputs` (floating ones
    as leaves that take gradients) with the draws from `gen_state`; the
    gradients `grad_outs` pulled back through it: (outputs, input
    gradients, {module key: its weights' flattened gradient})."""
    from styletts2_tpu_torch.train.stage2 import SLM_KEYS

    dev = tr.device
    x = {k: None if v is None else v.detach().to(dev).requires_grad_(v.is_floating_point())
         for k, v in inputs.items()}
    for k in SLM_KEYS:
        tr.models[k].zero_grad(set_to_none=True)
    gen = torch.Generator()
    gen.set_state(gen_state)
    with _draws(gen, source):
        out = fn(tr, **x)
    pairs = [(out[k], g.to(dev)) for k, g in grad_outs.items() if out[k].requires_grad]
    if pairs:
        torch.autograd.backward([o for o, _ in pairs], [g for _, g in pairs])
    grads = {k: v.grad for k, v in x.items() if v is not None and v.grad is not None}
    wgrads = {}
    for k in SLM_KEYS:
        gs = [p.grad.flatten() for n, p in tr.models[k].named_parameters()
              if p.grad is not None and "bias_hh" not in n]
        if gs:
            wgrads[k] = torch.cat(gs)
    return {k: v.detach() for k, v in out.items()}, grads, wgrads


def _slm_trainer(cfg, models, device):
    """A trainer of `models` in the SLM pass's modes, as
    `cs._stage2_losses_and_grads` sets them: eval mode, the SLM_KEYS taking
    gradients, the LSTMs in train mode (cuDNN's LSTM backward needs it)."""
    from styletts2_tpu_torch.train.stage2 import Stage2Trainer
    from styletts2_tpu_torch.train.state import TrainState

    return _slm_modes(Stage2Trainer(cfg, TrainState(models, {}, sigma_data=0.2), device))


def _slm_modes(tr):
    from styletts2_tpu_torch.train.stage2 import SLM_KEYS

    tr._modes(False, SLM_KEYS)
    for m in tr.models.values():
        for lstm in m.modules():
            if isinstance(lstm, torch.nn.LSTM):
                lstm.train()
    return tr


def _slm_inputs(tr, batch, starts, source):
    """The SLM pass's inputs as the step reaches them: (the CPU generator's
    state after the step's generator forward, the pass's rows
    (`_slm_rows`), the batch's tensors, the forward's aux)."""
    gen = torch.Generator().manual_seed(0)
    t = tr._tensors(batch)
    tr._modes(False, tr.gen_keys(True, True))
    with _draws(gen, source), torch.no_grad():
        _, _, _, aux = tr.generator_forward(t, starts, starts, 40, True, True, 3, 0.2, train=False)
    _slm_modes(tr)
    return gen.get_state(), tr._slm_rows(t, aux), t, aux


def bisect(cfg, models, batch, starts, source, seed, dev):
    """`--bisect`: the table of the docstring."""
    stages = _slm_stages()
    tr = _slm_trainer(cfg, models, "cpu")
    state, rows, t, aux = _slm_inputs(tr, batch, starts, source)
    env = dict(rows)
    gen = torch.Generator()
    gen.set_state(state)
    record = []
    with _draws(gen, source):  # the pass forward on the CPU, each module's inputs and draws kept
        for name, fn, ins in stages:
            inputs = {k: env[k] for k in ins}
            record.append((gen.get_state(), inputs))
            with torch.no_grad():
                out = fn(tr, **inputs)
            if tuple(out) != OUTPUTS[name]:
                raise RuntimeError(f"{name}: outputs {tuple(out)}")
            env.update(out)
    gen.set_state(state)
    with _draws(gen, source):
        want = tr.slm_generator_loss(t, aux, 3, False, 0.2)[0].item()
    print(f"SLM pass cut at its modules: loss {float(env['loss']):.8f}, the uncut pass's "
          f"{want:.8f}", flush=True)
    grad_of, cpu_runs = {"loss": torch.ones(())}, [None] * len(stages)
    for i in reversed(range(len(stages))):  # the gradients pulled back module by module
        name, fn, _ = stages[i]
        gen_state, inputs = record[i]
        grad_outs = {k: grad_of[k] for k in OUTPUTS[name] if k in grad_of}
        cpu_runs[i] = (grad_outs, _run_stage(tr, fn, inputs, grad_outs, gen_state, source))
        for k, g in cpu_runs[i][1][1].items():
            grad_of[k] = grad_of[k] + g if k in grad_of else g
    card = _slm_trainer(cfg, copy.deepcopy(models).to(dev), dev)
    moved_models = copy.deepcopy(models)
    _perturb(moved_models, seed)
    moved = _slm_trainer(cfg, moved_models, "cpu")
    g = torch.Generator().manual_seed(seed + 1000)
    print(f"module: card vs CPU from the CPU's inputs and output gradient (relative L2) | the "
          f"CPU's own movement under a 1e-7 change of the module's weights and inputs "
          f"(seed {seed}); out: outputs, d in: input gradients, d w: weight gradients")
    for i, (name, fn, _) in enumerate(stages):
        gen_state, inputs = record[i]
        grad_outs, want = cpu_runs[i]
        got = _run_stage(card, fn, inputs, grad_outs, gen_state, source)
        nudged = {k: v * (1 + 1e-7 * torch.randn(v.shape, generator=g))
                  if v is not None and v.is_floating_point() else v for k, v in inputs.items()}
        mv = _run_stage(moved, fn, nudged, grad_outs, gen_state, source)
        parts = []
        for kind, j in (("out", 0), ("d in", 1), ("d w", 2)):
            for k in want[j]:
                if not want[j][k].is_floating_point():
                    same = torch.equal(got[j][k].cpu(), want[j][k])
                    parts.append(f"{kind} {k} {'equal' if same else 'DIFFERS'}")
                    continue
                parts.append(f"{kind} {k} {_rel(got[j][k], want[j][k]):.2e} | "
                             f"{_rel(mv[j][k], want[j][k]):.2e}")
        print(f"  {name}: " + "; ".join(parts), flush=True)


OUTPUTS = {"PL-BERT + bert_encoder": ("bert_dur", "d_en"), "diffusion sampler": ("s_preds",),
           "predictor.encode_texts + duration": ("d", "dur_logits"),
           "soft_alignment": ("attn", "total"), "text_encoder": ("t_en",),
           "@ attn products": ("asr_pred", "p_pred"),
           "F0Ntrain": ("f0", "n", "starts", "valid"), "decoder": ("y_pred",),
           "resample_24k_to_16k": ("y16",), "WavLM": ("states",), "wd": ("d_g",),
           "loss": ("loss",)}


# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", choices=("noise", "zero", "sines"), default="noise")
    ap.add_argument("--istftnet", action="store_true")
    ap.add_argument("--seed", type=int, nargs="+", default=[5],
                    help="the draws of the change of the weights")
    ap.add_argument("--threads", type=int, default=None,
                    help="rerun on this many threads instead of changing the weights")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    ap.add_argument("--deterministic", action="store_true",
                    help="card: the step with cuDNN deterministic against the default")
    ap.add_argument("--bisect", action="store_true",
                    help="card: the SLM pass module by module against the CPU")
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA device")
        from styletts2_tpu_torch.utils import set_f32_compute

        set_f32_compute()
        import subprocess

        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    cfg, models, batch, starts = cs.stage2_reference_case(libritts=not args.istftnet)
    source = "sines" if args.istftnet else args.source
    kw = {} if args.istftnet else {"noise_source": args.source == "noise",
                                   "zero_sines": args.source == "zero"}
    what = "iSTFTNet" if args.istftnet else "source " + args.source

    def grads(m, dev):
        return cs._host_draws(cs._stage2_losses_and_grads, m, cfg, dev, batch, starts, **kw)[1]

    def table(title, after, before):
        print(title)
        for k, v in before.items():
            print(f"  {k}: {_rel(after[k], v):.2e}")

    if args.bisect:
        bisect(cfg, models, batch, starts, source, args.seed[0], torch.device(args.device))
        return
    dev = torch.device(args.device)
    on = copy.deepcopy(models).to(dev) if dev.type == "cuda" else models
    if args.deterministic:
        cpu = grads(models, "cpu")
        runs = {}
        for det in (False, True, False, True):
            torch.backends.cudnn.deterministic = det
            runs.setdefault(det, []).append(grads(on, dev))
        torch.backends.cudnn.deterministic = False
        for det, (a, b) in runs.items():
            table(f"{what}: the card twice, cudnn.deterministic={det}: each gradient moves by",
                  b, a)
        table(f"{what}: the card, deterministic against the default", runs[True][0],
              runs[False][0])
        for det in (False, True):
            table(f"{what}: the card (cudnn.deterministic={det}) against the CPU",
                  runs[det][0], cpu)
        return
    before = grads(on, dev)
    if args.threads is not None:
        torch.set_num_threads(args.threads)
        table(f"{what}: {args.threads} threads instead of 4 moves each gradient by (L2, relative)",
              grads(on, dev), before)
        return
    for seed in args.seed:
        moved = copy.deepcopy(on)
        _perturb(moved, seed)
        table(f"{what} on {dev.type}: a 1e-7 change of the weights (seed {seed}) moves each "
              "gradient by (L2, relative)", grads(moved, dev), before)


if __name__ == "__main__":
    main()
