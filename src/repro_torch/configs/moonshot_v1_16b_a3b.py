"""moonshot-v1-16b-a3b [moe]
48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840, MoE 64e top-6.
[hf:moonshotai/Moonlight-16B-A3B; hf]

Moonlight-style fine-grained MoE: 64 routed experts (top-6) + 2 shared
experts with per-expert d_ff=1408, MoE in every layer. Counterpart of
`repro/configs/moonshot_v1_16b_a3b.py`. In bf16 the published model's
~28.89 B parameters (57.8 GB) fit one 80 GB card whole.
"""
from __future__ import annotations

from repro_torch.configs.base import (ArchSpec, LM_SHAPES, lm_donate,
                                      lm_input_specs, lm_step,
                                      lm_tune_for_mesh)
from repro_torch.nn.moe import MoEConfig
from repro_torch.nn.transformer import TransformerConfig, TransformerLM

CONFIG = TransformerConfig(
    name="moonshot-v1-16b-a3b",
    n_layers=48, d_model=2048, n_heads=16, n_kv=16, head_dim=128,
    d_ff=1408, vocab=163840,
    moe=MoEConfig(num_experts=64, top_k=6, d_ff=1408, every=1, n_shared=2,
                  capacity_factor=1.25),
    rope_theta=50000.0)

REDUCED = TransformerConfig(
    name="moonshot-reduced",
    n_layers=2, d_model=64, n_heads=4, n_kv=4, head_dim=16, d_ff=96,
    vocab=512,
    moe=MoEConfig(num_experts=8, top_k=3, d_ff=48, every=1, n_shared=2,
                  capacity_factor=2.0),
    dtype="float32", loss_chunks=2)

SPEC = ArchSpec(
    name="moonshot-v1-16b-a3b", family="lm",
    build=lambda device=None, seed=0, train=False: TransformerLM(
        CONFIG, device, seed, train),
    build_reduced=lambda device=None, seed=0, train=False: TransformerLM(
        REDUCED, device, seed, train),
    shapes=LM_SHAPES,
    input_specs=lm_input_specs,
    step=lm_step,
    tune_for_mesh=lm_tune_for_mesh,
    donate_inputs=lm_donate,
    notes="kimi/moonlight fine-grained MoE, 64e top-6 + 2 shared.")
