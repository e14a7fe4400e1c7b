"""llama4-maverick-400b-a17b [moe]
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

MoE every other layer (interleave step 2, the Maverick layout) + one shared
expert: 24 dense + 24 MoE layers give the ~400B total / ~17B active
parameter split of the published model. Early-fusion multimodality
concerns the vision frontend only; the backbone is modeled. Counterpart
of `repro/configs/llama4_maverick_400b_a17b.py`. One MoE layer alone
holds 16.1 B parameters: one card runs REDUCED.
"""
from __future__ import annotations

from repro_torch.configs.base import (ArchSpec, LM_SHAPES, lm_donate,
                                      lm_input_specs, lm_step,
                                      lm_tune_for_mesh)
from repro_torch.nn.moe import MoEConfig
from repro_torch.nn.transformer import TransformerConfig, TransformerLM

CONFIG = TransformerConfig(
    name="llama4-maverick-400b-a17b",
    n_layers=48, d_model=5120, n_heads=40, n_kv=8, head_dim=128,
    d_ff=16384,                       # dense-layer FFN
    vocab=202048,
    moe=MoEConfig(num_experts=128, top_k=1, d_ff=8192, every=2, n_shared=1,
                  capacity_factor=1.25),
    rope_theta=500000.0)

REDUCED = TransformerConfig(
    name="llama4-maverick-reduced",
    n_layers=4, d_model=64, n_heads=4, n_kv=2, head_dim=16, d_ff=128,
    vocab=512,
    moe=MoEConfig(num_experts=8, top_k=1, d_ff=64, every=2, n_shared=1,
                  capacity_factor=2.0),
    dtype="float32", loss_chunks=2)

SPEC = ArchSpec(
    name="llama4-maverick-400b-a17b", family="lm",
    build=lambda device=None, seed=0, train=False: TransformerLM(
        CONFIG, device, seed, train),
    build_reduced=lambda device=None, seed=0, train=False: TransformerLM(
        REDUCED, device, seed, train),
    shapes=LM_SHAPES,
    input_specs=lm_input_specs,
    step=lm_step,
    tune_for_mesh=lm_tune_for_mesh,
    donate_inputs=lm_donate,
    notes="MoE 128e top-1 every 2nd layer + 1 shared expert; ~400B total.")
