"""The tiny training configuration (`styletts2_tpu/parallel/tiny.py:17-49`):
every module, loss and tensor-parallel layout of the real steps at shrunk
channel widths, for CPU tests and the fidelity tool's tiny runs. Only the
config is ported: the port builds its modules with
`models.build.build_training_models`.
"""

from __future__ import annotations

from styletts2_tpu_torch.config import Config


def tiny_config() -> Config:
    """`Config()` at tiny widths, field for field the JAX package's. PL-BERT
    keeps a 1536-wide feed-forward, so the tensor-parallel layout shards a
    side of 1024 or more, as at full width."""
    cfg = Config()
    pb, mp = cfg.plbert_params, cfg.model_params
    pb.num_hidden_layers = 1
    pb.hidden_size = 128
    pb.intermediate_size = 1536
    pb.num_attention_heads = 4
    pb.embedding_size = 64
    mp.hidden_dim = 128
    mp.max_conv_dim = 128
    mp.style_dim = 64
    mp.dim_in = 32
    mp.diffusion.transformer.num_layers = 1
    mp.decoder.upsample_initial_channel = 128
    # one resblock kernel of two dilations, depth-1 text and duration encoders
    mp.decoder.resblock_kernel_sizes = [3]
    mp.decoder.resblock_dilation_sizes = [[1, 3]]
    cfg.max_len = 80
    cfg.slmadv_params.min_len = 80
    cfg.slmadv_params.max_len = 120
    mp.slm.hidden = 64
    mp.slm.nlayers = 3
    return cfg
