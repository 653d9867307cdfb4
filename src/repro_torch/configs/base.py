"""Model configuration schema covering all 10 assigned architectures."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0               # 0 -> d_model // n_heads
    # layer pattern, tiled to cover n_layers; kinds: attn | local | ssm | rglru
    pattern: tuple = ("attn",)
    window: int = 0               # sliding window for "local" layers
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    d_expert: int = 0
    first_dense: int = 0          # deepseek-moe: leading dense layers
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    moe_expert_parallel: bool = False  # shard experts (not d_expert) over 'model'
    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # RG-LRU (recurrentgemma)
    lru_width: int = 0            # 0 -> d_model
    conv_width: int = 4
    # encoder-decoder (whisper)
    enc_layers: int = 0
    enc_seq: int = 1500
    # modality frontend stubs ("" | vit | audio)
    stub_frontend: str = ""
    n_img_tokens: int = 256       # vlm: precomputed patch-embedding tokens
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    act: str = "silu"
    # train-time knobs (overridable per run)
    remat: bool = True
    remat_policy: str = "nothing"  # nothing | dots (save matmul outputs)
    scan_layers: bool = True
    attn_chunk: int = 2048  # blockwise-attention tile (0 = naive full scores)
    # serving: error-bounded int8 KV-cache compression (paper technique
    # applied to the decode memory roofline); 0 = off
    kv_quant: int = 0
    # cast fp32 master weights to bf16 *before* the FSDP all-gather (halves
    # weight-gather bytes; grads still accumulate fp32). §Perf lever.
    bf16_params: bool = False
    # sharding policy pins (-1 = auto by param count). The dry-run's reduced
    # depth variants pin these to the full model's decisions.
    force_fsdp: int = -1
    force_seqpar: int = -1

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // max(self.n_heads, 1))
        assert (self.n_layers - self.first_dense) % len(self.pattern) == 0 or not self.scan_layers, (
            f"{self.name}: n_layers {self.n_layers} (minus {self.first_dense} dense prefix) not divisible "
            f"by pattern {self.pattern}; set scan_layers=False or fix the pattern"
        )

    @property
    def n_groups(self) -> int:
        return (self.n_layers - self.first_dense) // len(self.pattern)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def lru_dim(self) -> int:
        return self.lru_width or self.d_model

    def scaled(self, **kw) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        base = dict(
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_head=16,
            d_ff=128,
            vocab=512,
            window=min(self.window, 16) if self.window else 0,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            d_expert=32 if self.d_expert else 0,
            n_shared=min(self.n_shared, 1),
            n_layers=2 * len(self.pattern) + self.first_dense,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else 64,
            ssm_chunk=16,
            lru_width=32 if self.lru_width or "rglru" in self.pattern else 0,
            enc_layers=2 if self.enc_layers else 0,
            enc_seq=32 if self.enc_layers else 1500,
            n_img_tokens=8 if self.stub_frontend == "vit" else self.n_img_tokens,
        )
        base.update(kw)
        return dataclasses.replace(self, **base)


def param_count(cfg: ModelConfig) -> int:
    """Approximate parameter count (embedding + blocks), for roofline math."""
    d, ff, V = cfg.d_model, cfg.d_ff, cfg.vocab
    H, Hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    layers = [cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)]
    attn_p = d * (H * dh) + 2 * d * (Hk * dh) + (H * dh) * d
    mlp_p = 3 * d * ff if cfg.act == "silu" else 2 * d * ff
    if cfg.n_experts:
        mlp_p = d * cfg.n_experts + cfg.n_experts * 3 * d * cfg.d_expert + cfg.n_shared * 3 * d * cfg.d_expert
    total = 0
    for kind in layers:
        if kind in ("attn", "local"):
            total += attn_p + mlp_p + 2 * d
        elif kind == "ssm":
            di, N, Hs = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
            total += d * (2 * di + 2 * N + Hs) + di * d + cfg.ssm_conv * (di + 2 * N) + 3 * Hs + 2 * d
        elif kind == "rglru":
            L = cfg.lru_dim
            total += 2 * d * L + L * d + cfg.conv_width * L + 2 * L * L + L + 2 * d
    if cfg.enc_layers:
        total += cfg.enc_layers * (2 * attn_p + mlp_p + 3 * d)  # enc + cross-attn in dec counted roughly
    total += V * d * (1 if cfg.tie_embeddings else 2) + d
    return int(total)


def active_param_count(cfg: ModelConfig) -> int:
    """Per-token active parameters (MoE: top_k + shared experts only)."""
    if not cfg.n_experts:
        return param_count(cfg)
    full = param_count(cfg)
    layers_moe = sum(1 for i in range(cfg.n_layers) if cfg.pattern[i % len(cfg.pattern)] in ("attn", "local") and i >= cfg.first_dense)
    inactive = layers_moe * (cfg.n_experts - cfg.top_k) * 3 * cfg.d_model * cfg.d_expert
    return int(full - inactive)
