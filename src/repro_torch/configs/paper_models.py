"""Shape tables for the models the PAPER evaluates, so our fragmentation /
peak-memory benchmarks can be compared against the paper's own numbers
(Figs. 8, 11, 15–18; Tables II, IV, VI).

These are census-only configs: they drive the pool/allocator/I-O accounting
benchmarks, not the JAX model zoo.
"""

from .base import ModelConfig, MoEConfig

PAPER_MODELS: dict[str, ModelConfig] = {
    "llama3.1-8b": ModelConfig(
        name="llama3.1-8b", family="dense", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=14336, vocab=128_256, head_dim=128,
        source="arXiv:2407.21783"),
    "qwen2.5-7b": ModelConfig(
        name="qwen2.5-7b", family="dense", n_layers=28, d_model=3584,
        n_heads=28, n_kv_heads=4, d_ff=18944, vocab=152_064, head_dim=128,
        source="arXiv:2412.15115"),
    "qwen2.5-14b": ModelConfig(
        name="qwen2.5-14b", family="dense", n_layers=48, d_model=5120,
        n_heads=40, n_kv_heads=8, d_ff=13824, vocab=152_064, head_dim=128,
        source="arXiv:2412.15115"),
    "qwen2.5-32b": ModelConfig(
        name="qwen2.5-32b", family="dense", n_layers=64, d_model=5120,
        n_heads=40, n_kv_heads=8, d_ff=27648, vocab=152_064, head_dim=128,
        source="arXiv:2412.15115"),
    "qwen3-30b-a3b": ModelConfig(
        name="qwen3-30b-a3b", family="moe", n_layers=48, d_model=2048,
        n_heads=32, n_kv_heads=4, d_ff=768, vocab=151_936, head_dim=128,
        qk_norm=True,
        moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768),
        source="hf:Qwen/Qwen3-30B-A3B"),
    "qwen2.5-0.5b": ModelConfig(
        name="qwen2.5-0.5b", family="dense", n_layers=24, d_model=896,
        n_heads=14, n_kv_heads=2, d_ff=4864, vocab=151_936, head_dim=64,
        tie_embeddings=True, source="arXiv:2412.15115"),
}
