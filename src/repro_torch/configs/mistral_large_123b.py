"""mistral-large-123b [dense]
88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768.
[hf:mistralai/Mistral-Large-Instruct-2407; unverified]

Counterpart of `repro/configs/mistral_large_123b.py`. 246 GB in bf16:
one card runs REDUCED.
"""
from __future__ import annotations

from repro_torch.configs.base import (ArchSpec, LM_SHAPES, lm_donate,
                                      lm_input_specs, lm_step,
                                      lm_tune_for_mesh)
from repro_torch.nn.transformer import TransformerConfig, TransformerLM

CONFIG = TransformerConfig(
    name="mistral-large-123b",
    n_layers=88, d_model=12288, n_heads=96, n_kv=8, head_dim=128,
    d_ff=28672, vocab=32768, rope_theta=1000000.0)

REDUCED = TransformerConfig(
    name="mistral-large-reduced",
    n_layers=4, d_model=64, n_heads=8, n_kv=2, head_dim=8, d_ff=160,
    vocab=512, dtype="float32", loss_chunks=2)

SPEC = ArchSpec(
    name="mistral-large-123b", family="lm",
    build=lambda device=None, seed=0, train=False: TransformerLM(
        CONFIG, device, seed, train),
    build_reduced=lambda device=None, seed=0, train=False: TransformerLM(
        REDUCED, device, seed, train),
    shapes=LM_SHAPES,
    input_specs=lm_input_specs,
    step=lm_step,
    tune_for_mesh=lm_tune_for_mesh,
    donate_inputs=lm_donate,
    notes="deepest assigned config (88L); dense GQA.")
