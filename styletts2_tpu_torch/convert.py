"""JAX parameter tree, or a reference checkpoint's `net`, -> the port's
state_dict.

`state_dict_from_jax(params, cfg)` takes the JAX package's variables for the
modules `build.module_keys(cfg)` names ({module: {"params": tree}}, plus a
"spectral" collection for the style encoders, with numpy-convertible
leaves) and returns `{"<module>.<reference torch name>": tensor}`, the
layout of `build_models(cfg).state_dict()`. It is the exact inverse of
`styletts2_tpu/convert.py:convert_styletts2_checkpoint` on those modules:
  Dense (in, out) -> Linear (out, in); Conv (K, in, out) -> (out, in, K);
  weight-norm v likewise, g -> (C, 1, 1); ConvTranspose v stays
  (in, out/groups, K); snake alpha (1, 1, C) -> (1, C, 1); LayerNorm
  scale -> weight; the LSTM's single bias b goes to bias_ih and bias_hh is 0;
  a spectral-norm Conv2d kernel (kh, kw, in, out) -> weight_orig
  (out, in, kh, kw), u -> weight_u, and v from (kh, kw, in) to torch's
  (in, kh, kw) flattening -> weight_v.
The stage-1 modules (`build.build_training_models`) convert as the exact
inverse of `convert_asr`, `convert_jdc` (BatchNorm running statistics
included; num_batches_tracked 0), `convert_mpd`, `convert_msd` and
`convert_wavlm` (the scanned layers 1..N-1 unstacked; the positional conv's
folded weight as the plain `weight`), and stage 2's WavLM discriminator
`wd` as the exact inverse of `convert_wd`.

`state_dict_from_reference(net, cfg)` reads the `net` dict of a StyleTTS 2
checkpoint ({module: state_dict}, the reference's `.pth` or the port's own
trainer files): the port's module names are the reference's, so it strips
DataParallel's `module.` prefixes and takes the diffusion model's `unet.`
weights, and reads nothing else.

`wavlm_from_hf(path)` builds the WavLM of a local Hugging Face directory
(`config.json` and `pytorch_model.bin` or `model.safetensors`, as
`WavLMModel.save_pretrained` writes them) without `transformers` or
`safetensors`; `hf_model_dir(name)` finds a hub name's snapshot in the local
cache only (`styletts2_tpu/train/run.py:119-140`, `convert.py:50-106`).
"""

from __future__ import annotations

import json
import logging
import os
import struct
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from styletts2_tpu_torch.config import Config
from styletts2_tpu_torch.models import wavlm
from styletts2_tpu_torch.models.build import module_keys, parameter_names


def _np(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32))


def _lin(p, sd, name):
    sd[f"{name}.weight"] = _np(p["kernel"]).T
    if "bias" in p:
        sd[f"{name}.bias"] = _np(p["bias"])


def _ln(p, sd, name):
    sd[f"{name}.weight"] = _np(p["scale"])
    sd[f"{name}.bias"] = _np(p["bias"])


def _conv1d(p, sd, name):
    sd[f"{name}.weight"] = _np(p["kernel"]).transpose(2, 1, 0)
    if "bias" in p:
        sd[f"{name}.bias"] = _np(p["bias"])


def _wnconv1d(p, sd, name):
    sd[f"{name}.weight_v"] = _np(p["v"]).transpose(2, 1, 0)
    sd[f"{name}.weight_g"] = _np(p["g"]).reshape(-1, 1, 1)
    if "bias" in p:
        sd[f"{name}.bias"] = _np(p["bias"])


def _wnconvtr1d(p, sd, name):
    sd[f"{name}.weight_v"] = _np(p["v"])
    sd[f"{name}.weight_g"] = _np(p["g"]).reshape(-1, 1, 1)
    if "bias" in p:
        sd[f"{name}.bias"] = _np(p["bias"])


def _snconv2d(p, spec, sd, name):
    k = _np(p["kernel"])  # (kh, kw, in, out)
    kh, kw, cin, _ = k.shape
    sd[f"{name}.weight_orig"] = k.transpose(3, 2, 0, 1)
    if "bias" in p:
        sd[f"{name}.bias"] = _np(p["bias"])
    sd[f"{name}.weight_u"] = _np(spec["u"])
    sd[f"{name}.weight_v"] = _np(spec["v"]).reshape(kh, kw, cin).transpose(2, 0, 1).reshape(-1)


def _bilstm(p, sd, name):
    for d, suffix in (("fwd", ""), ("bwd", "_reverse")):
        q = p[d]
        sd[f"{name}.weight_ih_l0{suffix}"] = _np(q["W_ih"]).T
        sd[f"{name}.weight_hh_l0{suffix}"] = _np(q["W_hh"]).T
        sd[f"{name}.bias_ih_l0{suffix}"] = _np(q["b"])
        sd[f"{name}.bias_hh_l0{suffix}"] = np.zeros_like(_np(q["b"]))


def _count(p, prefix):
    return sum(1 for k in p if k.startswith(prefix))


def _text_encoder(p, sd):
    sd["embedding.weight"] = _np(p["embedding"]["embedding"])
    for i in range(_count(p, "cnn_")):
        _wnconv1d(p[f"cnn_{i}"], sd, f"cnn.{i}.0")
        sd[f"cnn.{i}.1.gamma"] = _np(p[f"norm_{i}"]["gamma"])
        sd[f"cnn.{i}.1.beta"] = _np(p[f"norm_{i}"]["beta"])
    _bilstm(p["lstm"], sd, "lstm")


def _bert(p, sd):
    sd["embeddings.word_embeddings.weight"] = _np(p["word_embeddings"]["embedding"])
    sd["embeddings.position_embeddings.weight"] = _np(p["position_embeddings"])
    sd["embeddings.token_type_embeddings.weight"] = _np(p["token_type_embeddings"])
    _ln(p["emb_ln"], sd, "embeddings.LayerNorm")
    _lin(p["emb_proj"], sd, "encoder.embedding_hidden_mapping_in")
    b = "encoder.albert_layer_groups.0.albert_layers.0"
    layer = p["layer"]
    for mine, theirs in (("q", "attention.query"), ("k", "attention.key"),
                         ("v", "attention.value"), ("attn_out", "attention.dense"),
                         ("ffn", "ffn"), ("ffn_out", "ffn_output")):
        _lin(layer[mine], sd, f"{b}.{theirs}")
    _ln(layer["attn_ln"], sd, f"{b}.attention.LayerNorm")
    _ln(layer["ffn_ln"], sd, f"{b}.full_layer_layer_norm")


def _bert_encoder(p, sd):
    sd["weight"] = _np(p["proj"]["kernel"]).T
    sd["bias"] = _np(p["proj"]["bias"])


def _style_encoder(v, sd):
    p, spec = v["params"], v["spectral"]
    n = _count(p, "block_")
    _snconv2d(p["stem"], spec["stem"], sd, "shared.0")
    for i in range(n):
        bp, bs, b = p[f"block_{i}"], spec[f"block_{i}"], f"shared.{1 + i}"
        for mine, theirs in (("conv1", "conv1"), ("conv2", "conv2"),
                             ("downsample_res", "downsample_res.conv"), ("conv1x1", "conv1x1")):
            if mine in bp:
                _snconv2d(bp[mine], bs[mine], sd, f"{b}.{theirs}")
    _snconv2d(p["conv5x5"], spec["conv5x5"], sd, f"shared.{n + 2}")
    _lin(p["unshared"], sd, "unshared")


def _adain_res_blk1d(p, sd, base):
    _lin(p["norm1"]["fc"], sd, f"{base}.norm1.fc")
    _lin(p["norm2"]["fc"], sd, f"{base}.norm2.fc")
    _wnconv1d(p["conv1"], sd, f"{base}.conv1")
    _wnconv1d(p["conv2"], sd, f"{base}.conv2")
    if "pool" in p:
        _wnconvtr1d(p["pool"], sd, f"{base}.pool")
    if "conv1x1" in p:
        _wnconv1d(p["conv1x1"], sd, f"{base}.conv1x1")


def _predictor(p, sd):
    te = p["text_encoder"]
    for i in range(_count(te, "lstm_")):
        _bilstm(te[f"lstm_{i}"], sd, f"text_encoder.lstms.{2 * i}")
        _lin(te[f"ada_{i}"]["fc"], sd, f"text_encoder.lstms.{2 * i + 1}.fc")
    _bilstm(p["lstm"], sd, "lstm")
    _lin(p["duration_proj"], sd, "duration_proj.linear_layer")
    _bilstm(p["shared"], sd, "shared")
    for branch, mine in (("F0", "F0_blocks"), ("N", "N_blocks")):
        for j in range(_count(p, f"{mine}_")):
            _adain_res_blk1d(p[f"{mine}_{j}"], sd, f"{branch}.{j}")
    _conv1d(p["F0_proj"], sd, "F0_proj")
    _conv1d(p["N_proj"], sd, "N_proj")


def _adain_res_block1(p, sd, base):
    for j in range(_count(p, "conv1_")):
        _wnconv1d(p[f"conv1_{j}"], sd, f"{base}.convs1.{j}")
        _wnconv1d(p[f"conv2_{j}"], sd, f"{base}.convs2.{j}")
        _lin(p[f"adain1_{j}"]["fc"], sd, f"{base}.adain1.{j}.fc")
        _lin(p[f"adain2_{j}"]["fc"], sd, f"{base}.adain2.{j}.fc")
        sd[f"{base}.alpha1.{j}"] = _np(p[f"alpha1_{j}"]).transpose(0, 2, 1)
        sd[f"{base}.alpha2.{j}"] = _np(p[f"alpha2_{j}"]).transpose(0, 2, 1)


def _decoder(p, sd):
    _adain_res_blk1d(p["encode"], sd, "encode")
    for i in range(_count(p, "decode_")):
        _adain_res_blk1d(p[f"decode_{i}"], sd, f"decode.{i}")
    _wnconv1d(p["F0_conv"], sd, "F0_conv")
    _wnconv1d(p["N_conv"], sd, "N_conv")
    _wnconv1d(p["asr_res"], sd, "asr_res.0")
    g = p["generator"]
    _lin(g["m_source"]["l_linear"], sd, "generator.m_source.l_linear")
    for i in range(_count(g, "alpha_")):  # HiFi-GAN's per-stage snakes
        sd[f"generator.alphas.{i}"] = _np(g[f"alpha_{i}"]).transpose(0, 2, 1)
    num_kernels = len({k.split("_")[2] for k in g if k.startswith("resblocks_")})
    for i in range(_count(g, "ups_")):
        _wnconvtr1d(g[f"ups_{i}"], sd, f"generator.ups.{i}")
        _conv1d(g[f"noise_convs_{i}"], sd, f"generator.noise_convs.{i}")
        _adain_res_block1(g[f"noise_res_{i}"], sd, f"generator.noise_res.{i}")
        for j in range(num_kernels):
            _adain_res_block1(g[f"resblocks_{i}_{j}"], sd,
                              f"generator.resblocks.{i * num_kernels + j}")
    _wnconv1d(g["conv_post"], sd, "generator.conv_post")


def _diffusion(p, sd):
    sd["fixed_embedding.embedding.weight"] = _np(p["fixed_embedding"])
    sd["to_time.0.0.weights"] = _np(p["to_time"]["weights"])
    _lin(p["to_time"]["proj"], sd, "to_time.0.1")
    if "to_features" in p:  # multispeaker
        _lin(p["to_features"], sd, "to_features.0")
    _lin(p["map1"], sd, "to_mapping.0")
    _lin(p["map2"], sd, "to_mapping.2")
    for i in range(_count(p, "block_")):
        b = f"blocks.{i}"
        att = p[f"block_{i}"]["attention"]
        _lin(att["to_q"], sd, f"{b}.attention.to_q")
        _lin(att["to_kv"], sd, f"{b}.attention.to_kv")
        _lin(att["to_out"], sd, f"{b}.attention.attention.to_out")
        for norm in ("norm", "norm_context"):
            if "fc" in att[norm]:  # the multispeaker AdaLayerNorm
                _lin(att[norm]["fc"], sd, f"{b}.attention.{norm}.fc")
            else:
                _ln(att[norm], sd, f"{b}.attention.{norm}")
        ff = p[f"block_{i}"]["feed_forward"]
        _lin(ff["in"], sd, f"{b}.feed_forward.0")
        _lin(ff["out"], sd, f"{b}.feed_forward.2")
    sd["to_out.1.weight"] = _np(p["to_out"]["kernel"]).T[:, :, None]
    sd["to_out.1.bias"] = _np(p["to_out"]["bias"])


def _gn(p, sd, name):
    _ln(p, sd, name)  # GroupNorm and LayerNorm keep scale/bias alike


def _asr(p, sd):
    _conv1d(p["init_cnn"], sd, "init_cnn.conv")
    for i in range(_count(p, "cnns_")):
        blk = p[f"cnns_{i}"]
        for j in range(_count(blk, "gn")):
            base = f"cnns.{i}.0.blocks.{j}"
            _conv1d(blk[f"c{j}_1"], sd, f"{base}.0.conv")
            _gn(blk[f"gn{j}"], sd, f"{base}.2")
            _conv1d(blk[f"c{j}_2"], sd, f"{base}.4.conv")
        _gn(p[f"cnn_norms_{i}"], sd, f"cnns.{i}.1")
    _conv1d(p["projection"], sd, "projection.conv")
    _lin(p["ctc1"], sd, "ctc_linear.0.linear_layer")
    _lin(p["ctc2"], sd, "ctc_linear.2.linear_layer")
    q, b = p["asr_s2s"], "asr_s2s"
    att = f"{b}.attention_layer"
    sd[f"{b}.embedding.weight"] = _np(q["embedding"]["embedding"])
    sd[f"{att}.memory_layer.linear_layer.weight"] = _np(q["memory_layer"]["kernel"]).T
    sd[f"{att}.query_layer.linear_layer.weight"] = _np(q["query_layer"]).T
    sd[f"{att}.v.linear_layer.weight"] = _np(q["v"]).T
    sd[f"{att}.location_layer.location_conv.conv.weight"] = _np(q["location_conv"]).transpose(2, 1, 0)
    sd[f"{att}.location_layer.location_dense.linear_layer.weight"] = _np(q["location_dense"]).T
    sd[f"{b}.decoder_rnn.weight_ih"] = _np(q["W_ih"]).T
    sd[f"{b}.decoder_rnn.weight_hh"] = _np(q["W_hh"]).T
    sd[f"{b}.decoder_rnn.bias_ih"] = _np(q["b_cell"])
    sd[f"{b}.decoder_rnn.bias_hh"] = np.zeros_like(_np(q["b_cell"]))
    sd[f"{b}.project_to_hidden.0.linear_layer.weight"] = _np(q["project_to_hidden_w"]).T
    sd[f"{b}.project_to_hidden.0.linear_layer.bias"] = _np(q["project_to_hidden_b"])
    sd[f"{b}.project_to_n_symbols.weight"] = _np(q["project_to_n_symbols_w"]).T
    sd[f"{b}.project_to_n_symbols.bias"] = _np(q["project_to_n_symbols_b"])


def _conv2d(p, sd, name):
    sd[f"{name}.weight"] = _np(p["kernel"]).transpose(3, 2, 0, 1)


def _bn(p, stats, sd, name):
    sd[f"{name}.weight"] = _np(p["scale"])
    sd[f"{name}.bias"] = _np(p["bias"])
    sd[f"{name}.running_mean"] = _np(stats["mean"])
    sd[f"{name}.running_var"] = _np(stats["var"])
    sd[f"{name}.num_batches_tracked"] = np.zeros((), np.int64)


def _jdc(v, sd):
    p, st = v["params"], v["batch_stats"]
    _conv2d(p["conv0"], sd, "conv_block.0")
    _bn(p["bn0"], st["bn0"], sd, "conv_block.1")
    _conv2d(p["conv1"], sd, "conv_block.3")
    for i in (1, 2, 3):
        r, bp, bs = f"res_block{i}", p[f"res{i}"], st[f"res{i}"]
        _bn(bp["pre_bn"], bs["pre_bn"], sd, f"{r}.pre_conv.0")
        _conv2d(bp["conv1"], sd, f"{r}.conv.0")
        _bn(bp["bn1"], bs["bn1"], sd, f"{r}.conv.1")
        _conv2d(bp["conv2"], sd, f"{r}.conv.3")
        if "conv1x1" in bp:
            _conv2d(bp["conv1x1"], sd, f"{r}.conv1by1")
    _bn(p["pool_bn"], st["pool_bn"], sd, "pool_block.0")
    _bilstm(p["bilstm_classifier"], sd, "bilstm_classifier")
    _lin(p["classifier"], sd, "classifier")


def _wnconv2d(p, sd, name):
    sd[f"{name}.weight_v"] = _np(p["v"]).transpose(3, 2, 0, 1)
    sd[f"{name}.weight_g"] = _np(p["g"]).reshape(-1, 1, 1, 1)
    sd[f"{name}.bias"] = _np(p["bias"])


def _mpd(p, sd):
    for i, key in enumerate(sorted(p, key=lambda k: int(k[1:]))):  # p2, p3, p5, ...
        for j in range(_count(p[key], "conv_") - 1):  # conv_0..conv_4 and conv_post
            _wnconv2d(p[key][f"conv_{j}"], sd, f"discriminators.{i}.convs.{j}")
        _wnconv2d(p[key]["conv_post"], sd, f"discriminators.{i}.conv_post")


def _msd(p, sd):
    for i in range(_count(p, "r")):
        for j in range(_count(p[f"r{i}"], "conv_")):
            _wnconv2d(p[f"r{i}"][f"conv_{j}"], sd, f"discriminators.{i}.discriminators.{j}")
        _wnconv2d(p[f"r{i}"]["out"], sd, f"discriminators.{i}.out")


def _wd(p, sd):
    _wnconv1d(p["pre"], sd, "pre")
    for i in range(_count(p, "conv_") - 1):  # conv_0..conv_2 and conv_post
        _wnconv1d(p[f"conv_{i}"], sd, f"convs.{i}")
    _wnconv1d(p["conv_post"], sd, "conv_post")


def _wavlm_layer(p, sd, base):
    a = p["attention"]
    for name in ("q_proj", "k_proj", "v_proj", "out_proj", "gru_rel_pos_linear"):
        _lin(a[name], sd, f"{base}.attention.{name}")
    sd[f"{base}.attention.gru_rel_pos_const"] = _np(a["gru_rel_pos_const"])
    if "rel_attn_embed" in a:
        sd[f"{base}.attention.rel_attn_embed.weight"] = _np(a["rel_attn_embed"])
    _ln(p["layer_norm"], sd, f"{base}.layer_norm")
    _ln(p["final_layer_norm"], sd, f"{base}.final_layer_norm")
    _lin(p["ff_in"], sd, f"{base}.feed_forward.intermediate_dense")
    _lin(p["ff_out"], sd, f"{base}.feed_forward.output_dense")


def _wavlm(p, sd):
    fe = "feature_extractor.conv_layers"
    for i in range(_count(p, "conv_") - 1):  # conv_0..conv_6 and conv_gn
        sd[f"{fe}.{i}.conv.weight"] = _np(p[f"conv_{i}"]["kernel"]).transpose(2, 1, 0)
    _ln(p["conv_gn"], sd, f"{fe}.0.layer_norm")
    _ln(p["proj_ln"], sd, "feature_projection.layer_norm")
    _lin(p["proj"], sd, "feature_projection.projection")
    _conv1d(p["pos_conv"], sd, "encoder.pos_conv_embed.conv")
    _ln(p["encoder_ln"], sd, "encoder.layer_norm")
    _wavlm_layer(p["layer_0"], sd, "encoder.layers.0")
    stacked = p.get("layers", {}).get("layer")
    if stacked is not None:  # layers 1..N-1, stacked on a leading axis
        n = len(np.asarray(stacked["ff_in"]["bias"]))
        for i in range(n):
            one = _tree_map(lambda x, i=i: np.asarray(x)[i], stacked)
            _wavlm_layer(one, sd, f"encoder.layers.{i + 1}")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _params_only(fn):
    return lambda v, sd: fn(v["params"], sd)


_MODULES = {
    "text_encoder": _params_only(_text_encoder),
    "bert": _params_only(_bert),
    "bert_encoder": _params_only(_bert_encoder),
    "predictor": _params_only(_predictor),
    "decoder": _params_only(_decoder),
    "diffusion": _params_only(_diffusion),
    "style_encoder": _style_encoder,
    "predictor_encoder": _style_encoder,
    "text_aligner": _params_only(_asr),
    "pitch_extractor": _jdc,
    "mpd": _params_only(_mpd),
    "msd": _params_only(_msd),
    "wavlm": _params_only(_wavlm),
    "wd": _params_only(_wd),
}


def state_dict_from_jax(params: Dict[str, Any], cfg: Config,
                        keys: Optional[Sequence[str]] = None) -> Dict[str, torch.Tensor]:
    """JAX variables of `keys` (by default `cfg`'s synthesis modules) -> the
    port's state_dict of those modules."""
    out: Dict[str, torch.Tensor] = {}
    for key in keys or module_keys(cfg):
        sd: Dict[str, np.ndarray] = {}
        _MODULES[key](params[key], sd)
        for name, v in sd.items():
            out[f"{key}.{name}"] = torch.from_numpy(np.ascontiguousarray(v))
    return out


def state_dict_from_reference(net: Mapping[str, Mapping[str, torch.Tensor]], cfg: Config,
                              keys: Optional[Sequence[str]] = None) -> Dict[str, torch.Tensor]:
    """A checkpoint's `net` ({module: state_dict}) -> the port's state_dict
    of the synthesis modules `keys` (by default all of `cfg`'s), the
    counterpart of the JAX package's `strip_module_prefix` and
    `convert_styletts2_checkpoint`. Every key loses a leading `module.`; the
    diffusion module is its `unet.` weights without the prefix where the
    file has them (the reference's AudioDiffusionConditional, whose
    `diffusion.net.*` repeats the same UNet). Each LSTM keeps its bias_ih
    and bias_hh: the port's LSTMs add both, as the reference's do. A name a
    module needs that the file lacks is a RuntimeError naming both; the names
    nothing reads (ALBERT's pooler and position ids, `diffusion.net.*`) go
    into one log line."""
    keys = tuple(keys or module_keys(cfg))
    missing = [k for k in keys if k not in net]
    if missing:
        raise RuntimeError(f"the checkpoint has no weights for {missing}")
    out: Dict[str, torch.Tensor] = {}
    unused = []
    for key, names in parameter_names(cfg, keys).items():
        sd = {k[7:] if k.startswith("module.") else k: v for k, v in net[key].items()}
        if key == "diffusion" and any(k.startswith("unet.") for k in sd):
            unused += [f"diffusion.{k}" for k in sd if not k.startswith("unet.")]
            sd = {k[5:]: v for k, v in sd.items() if k.startswith("unet.")}
        for name in names:
            if name not in sd:
                raise RuntimeError(f"module {key!r}: the checkpoint has no {name!r}")
            out[f"{key}.{name}"] = sd[name]
        wanted = set(names)
        unused += [f"{key}.{k}" for k in sd if k not in wanted]
    if unused:
        shown = ", ".join(unused[:12]) + (", ..." if len(unused) > 12 else "")
        logging.getLogger(__name__).info(
            f"state_dict_from_reference: {len(unused)} names nothing reads: {shown}")
    return out


# ---------------------------------------------------------------------------
# WavLM from a local Hugging Face directory

# config.json fields the port's WavLM fixes, and their values there
# (`models/wavlm.py`: the conv stem and the grouped positional conv)
WAVLM_FIXED = {"conv_dim": [wavlm.CONV_DIM] * 7, "conv_kernel": list(wavlm.CONV_KERNELS),
               "conv_stride": list(wavlm.CONV_STRIDES), "num_conv_pos_embeddings": 128,
               "num_conv_pos_embedding_groups": 16}
_SAFETENSORS_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
                       "BF16": np.uint16, "I64": np.int64, "I32": np.int32, "I16": np.int16,
                       "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}


def hf_model_dir(name: str) -> Optional[str]:
    """The directory of a Hugging Face model: `name` itself when it is a
    directory, else the snapshot `refs/main` names of the hub name `name`
    in the local cache ($HF_HUB_CACHE, else $HF_HOME/hub, else
    ~/.cache/huggingface/hub). None when neither exists; nothing is fetched."""
    if os.path.isdir(name):
        return name
    cache = os.environ.get("HF_HUB_CACHE") or os.path.join(
        os.environ.get("HF_HOME") or os.path.join(os.path.expanduser("~"), ".cache", "huggingface"),
        "hub")
    repo = os.path.join(cache, "models--" + name.replace("/", "--"))
    try:
        with open(os.path.join(repo, "refs", "main")) as f:
            snapshot = os.path.join(repo, "snapshots", f.read().strip())
    except OSError:
        return None
    return snapshot if os.path.isdir(snapshot) else None


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A `.safetensors` file by its documented layout: a little-endian u64
    header length, a JSON header {name: {"dtype", "shape", "data_offsets"}}
    and the raw little-endian bytes after it."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, not read here")
        start, end = info["data_offsets"]
        dtype = np.dtype(_SAFETENSORS_DTYPES[info["dtype"]]).newbyteorder("<")
        a = np.frombuffer(data[start:end], dtype).astype(dtype.newbyteorder("="))
        t = torch.from_numpy(a).reshape(info["shape"])
        out[name] = t.view(torch.bfloat16) if info["dtype"] == "BF16" else t
    return out


def _hf_weights(path: str) -> Dict[str, torch.Tensor]:
    """The weights file of a Hugging Face directory; OSError naming the file
    where it cannot be read."""
    st, pt = os.path.join(path, "model.safetensors"), os.path.join(path, "pytorch_model.bin")
    if not (os.path.exists(st) or os.path.exists(pt)):
        raise FileNotFoundError(f"{path} has neither model.safetensors nor pytorch_model.bin")
    file = st if os.path.exists(st) else pt
    try:
        return (read_safetensors(st) if file == st else
                torch.load(pt, map_location="cpu", weights_only=True))
    except Exception as e:  # any unreadable file: a truncated one, another format
        raise OSError(f"could not read {file}: {type(e).__name__}: {e}") from e


def wavlm_from_hf(path: str) -> "wavlm.WavLM":
    """The WavLM of the Hugging Face directory `path`: built at the widths
    of its `config.json` (hidden_size, num_attention_heads,
    intermediate_size, num_hidden_layers), the fields the port fixes
    checked (ValueError where one differs), its weights read from
    `model.safetensors` or `pytorch_model.bin` under the port's names (HF's;
    a `wavlm.` prefix stripped), the positional conv's weight norm folded
    from either form (weight_g / weight_v, or parametrizations.weight.
    original0 / original1). A missing weight is a KeyError naming it and
    the file; the names nothing reads (masked_spec_embed, ...) go into one
    log line."""
    cfg_path = os.path.join(path, "config.json")
    with open(cfg_path) as f:
        hf = json.load(f)
    for key, want in WAVLM_FIXED.items():
        got = hf.get(key, want)
        if (list(got) if isinstance(got, (list, tuple)) else got) != want:
            raise ValueError(f"{cfg_path}: {key} {got}, the port's WavLM has {want}")
    model = wavlm.WavLM(hidden=hf["hidden_size"], heads=hf["num_attention_heads"],
                        intermediate=hf["intermediate_size"], num_layers=hf["num_hidden_layers"])
    sd = {k[6:] if k.startswith("wavlm.") else k: v for k, v in _hf_weights(path).items()}
    pos = "encoder.pos_conv_embed.conv"
    for g_name, v_name in ((f"{pos}.weight_g", f"{pos}.weight_v"),
                           (f"{pos}.parametrizations.weight.original0",
                            f"{pos}.parametrizations.weight.original1")):
        if g_name in sd and v_name in sd:  # weight norm over the kernel axis (dim=2)
            g, v = sd.pop(g_name).float(), sd.pop(v_name).float()
            sd[f"{pos}.weight"] = v / v.pow(2).sum(dim=(0, 1), keepdim=True).sqrt() * g
    state = {}
    for name, want in model.state_dict().items():
        if name not in sd:
            raise KeyError(f"{path}: no weight {name!r}")
        state[name] = sd.pop(name).to(want.dtype)
    model.load_state_dict(state)
    if sd:
        shown = ", ".join(sorted(sd)[:12]) + (", ..." if len(sd) > 12 else "")
        logging.getLogger(__name__).info(f"wavlm_from_hf: {len(sd)} names nothing reads: {shown}")
    return model
