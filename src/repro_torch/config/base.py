"""Config dataclasses, copied from ``repro.config.base``.

Same field names, defaults and methods as the reference (a test compares
them), and the same ``replace`` (dotted keys), ``asdict`` and
``config_fingerprint``. On one card there is no device mesh: ``MeshConfig``
names the replica axis and its size (the local-SGD replica count K), and
``TrainConfig.remat``/``scan_layers`` are kept for the reference's fields
only (the port loops over layers and keeps every activation).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block config (dense-routing einsum formulation)."""

    num_experts: int = 0           # 0 => dense FFN
    top_k: int = 2
    router_jitter: float = 0.0
    load_balance_coef: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block config."""

    state_dim: int = 128           # N — SSM state size per head
    head_dim: int = 64             # P — channels per SSD head
    expand: int = 2                # d_inner = expand * d_model
    chunk_size: int = 256          # SSD chunk length
    conv_width: int = 4


@dataclass(frozen=True)
class ModelConfig:
    """Unified architecture description covering every assigned family
    (the port builds the dense, ssm and hybrid families)."""

    name: str = "unnamed"
    family: str = "dense"          # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 512
    vocab_size: int = 1024
    head_dim: int = 0              # 0 => d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    norm_type: str = "rms"         # rms | layer (whisper)
    tie_embeddings: bool = False
    # seq-chunked cross-entropy: cap the materialized logits to
    # (B, ce_chunk, V) per step (0 ⇒ unchunked)
    ce_chunk: int = 0
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    # hybrid (zamba2-style): a shared attention+MLP block applied every
    # `shared_block_every` backbone layers.
    shared_block_every: int = 0
    # enc-dec (whisper-style)
    n_encoder_layers: int = 0
    # stubbed audio frontend: number of precomputed frame embeddings the
    # encoder consumes (whisper: 1500 = 30 s at 50 Hz post-conv)
    n_audio_frames: int = 0
    # vlm (paligemma-style): number of image-prefix positions provided by the
    # (stubbed) vision frontend.
    num_image_tokens: int = 0
    # long-context capability flag: sub-quadratic step cost in seq_len.
    subquadratic: bool = False
    dtype: str = "bfloat16"        # activation/computation dtype
    param_dtype: str = "float32"   # master parameter dtype

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.moe.num_experts > 0

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs and roofline)."""
        from repro_torch.models.registry import analytic_param_count

        return analytic_param_count(self)

    def active_param_count(self) -> int:
        from repro_torch.models.registry import analytic_param_count

        return analytic_param_count(self, active_only=True)


@dataclass(frozen=True)
class MeshConfig:
    """Logical device mesh. ``axis_names`` order is major→minor."""

    shape: Tuple[int, ...] = (1,)
    axis_names: Tuple[str, ...] = ("data",)
    # which mesh axis carries each parallelism role
    data_axis: str = "data"        # batch / FSDP axis
    model_axis: str = "model"      # TP / EP / SP axis
    replica_axis: str = ""         # local-SGD (MSF) replica axis; "" => none

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def axis_size(self, name: str) -> int:
        if not name or name not in self.axis_names:
            return 1
        return self.shape[self.axis_names.index(name)]


@dataclass(frozen=True)
class SyncConfig:
    """The paper's contribution as config: model-synchronization schedule.

    ``strategy``:
      * ``"sync_every_step"`` — canonical DDP (paper's MSF=1 analog).
      * ``"periodic"``        — H local steps between parameter averages
                                (paper's DMS / local SGD). ``period=H``.
      * ``"hierarchical"``    — every-step sync on the data axis, periodic
                                sync on the replica (pod) axis.

    ``overlap`` — how the residual sync cost is taken off the critical path:
      * ``"none"``    — blocking collective at the block boundary (paper).
      * ``"delayed"`` — stale-by-one averaging: block *i*'s averaged delta is
                        applied at the end of block *i+1*, so the collective
                        overlaps block *i+1*'s compute (Stich 2018 local-SGD
                        staleness regime).
      * ``"chunked"`` — round-robin the parameter tree into ``chunks`` shards
                        and sync one shard per block: each leaf syncs every
                        ``chunks·period`` steps and per-sync wire bytes shrink
                        ``chunks``×.

    ``topology`` — which replicas a sync point couples:
      * ``"all"``      — global collective (pmean/psum/all-gather); one
                         straggler stalls every replica.
      * ``"ring"``     — each replica averages with its two ``ppermute``
                         neighbors (mixing weight 1/3 each); O(1) neighbor
                         bytes per sync, no global barrier.
      * ``"pairwise"`` — rotating disjoint pairs (odd–even pairing by sync
                         round) average with weight 1/2; needs an even
                         replica count. Gossip reaches consensus only
                         geometrically (factor λ₂ per round — see
                         :func:`repro_torch.core.costmodel.gossip_lambda2`), so the
                         auto-tuner caps H tighter for sparse topologies.
    """

    strategy: str = "sync_every_step"
    period: int = 1                # H — data points/steps per sync (block size)
    compression: str = "none"      # none | int8
    error_feedback: bool = True    # residual accumulation for compression
    slowmo: float = 0.0            # outer momentum on sync delta (0 => off)
    slowmo_lr: float = 1.0
    eval_at_sync: bool = False     # paper's per-sync CV-accuracy computation
    overlap: str = "none"          # none | delayed | chunked
    chunks: int = 4                # R — shard count for overlap="chunked"
    topology: str = "all"          # all | ring | pairwise (gossip)
    # Asynchronous (unsynchronized-round) gossip: each replica mixes with
    # the *last received* neighbor model instead of the current-round one —
    # a double-buffered ppermute exchange (send this boundary, consume at
    # the next, bounded staleness = 1 round on the compiled path). Requires
    # a gossip topology; the exchange is already a full block off the
    # critical path, so overlap modes are rejected (they would compound the
    # staleness past the 1-round bound). The auto-tuner caps H by the
    # staleness-aware effective spectral gap
    # (:func:`repro_torch.core.costmodel.effective_spectral_gap`).
    gossip_async: bool = False
    # --- adaptive MSF (repro_torch.core.autotune.AdaptiveController) ------
    # When ``adaptive`` is on, the training driver re-solves the period
    # online from measured T_step/T_sync every ``adapt_every`` blocks
    # (``period`` is the starting H). ``adapt_hysteresis`` is the relative
    # change required before H actually moves (every move recompiles the
    # train block); target/drift mirror choose_period's knobs.
    adaptive: bool = False
    adapt_every: int = 16          # R — blocks between controller re-solves
    adapt_hysteresis: float = 0.25
    adapt_target_overhead: float = 0.05
    adapt_max_drift: float = 0.01
    # --- H-ladder runtime (repro_torch.runtime.ladder.LadderRuntime) -------
    # The live trainer pre-compiles the train block for a *ladder* of
    # periods sharing one state layout, so an adaptive H move mid-run is
    # a flush + pick-another-compiled-callable — no recompilation. The
    # ladder is geometric {1, ladder_base, ladder_base², …, adapt_h_max}
    # (plus ``period`` so the starting rung always exists) unless
    # ``adapt_ladder`` pins explicit rungs. ``adapt_rung_hysteresis`` is
    # the controller's move threshold in *rung units*: the re-solved H
    # must snap at least that many rungs away before the schedule moves
    # (geometric spacing already absorbs sub-factor-of-base noise).
    adapt_h_max: int = 64          # top rung of the geometric ladder
    adapt_ladder: Tuple[int, ...] = ()   # explicit rungs (overrides h_max)
    ladder_base: int = 2           # geometric ladder ratio
    adapt_rung_hysteresis: int = 1

    def ladder_rungs(self) -> Tuple[int, ...]:
        """The pre-compiled H ladder: sorted, unique, start rung included."""
        if self.adapt_ladder:
            rungs = set(int(h) for h in self.adapt_ladder)
        else:
            rungs, h = set(), 1
            while h <= max(1, self.adapt_h_max):
                rungs.add(h)
                h *= max(2, self.ladder_base)
        rungs.add(max(1, self.period))
        return tuple(sorted(rungs))

    @property
    def msf_label(self) -> str:
        tail = "" if self.overlap == "none" else f",overlap={self.overlap}"
        if self.topology != "all":
            tail += f",topo={self.topology}"
        if self.gossip_async:
            tail += ",async"
        if self.adaptive:
            tail += ",adaptive"
        return f"{self.strategy}(H={self.period},comp={self.compression}{tail})"


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "synthetic_lm"  # synthetic_lm | ijcnn1 | webspam | epsilon
    seq_len: int = 1024
    global_batch: int = 8
    seed: int = 0
    num_samples: int = 0           # 0 => dataset default
    features: int = 0
    sparsity: float = 0.0


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "sgd"              # sgd | momentum | adamw
    learning_rate: float = 1e-3
    schedule: str = "constant"     # constant | paper_inverse | cosine
    warmup_steps: int = 0
    total_steps: int = 1000
    momentum: float = 0.9
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.0         # 0 => off
    # dtype of adam/momentum moments. bf16 halves optimizer-state memory
    moment_dtype: str = "float32"


@dataclass(frozen=True)
class CheckpointConfig:
    directory: str = "/tmp/repro_ckpt"
    interval_steps: int = 100
    keep_last: int = 3
    async_write: bool = False


@dataclass(frozen=True)
class FaultToleranceConfig:
    step_deadline_sec: float = 0.0   # 0 => no straggler watchdog
    max_restarts: int = 3
    inject_failure_at: int = -1      # test hook: raise at this step
    inject_straggle_sec: float = 0.0


@dataclass(frozen=True)
class TrainConfig:
    """Top-level experiment config."""

    model: ModelConfig = field(default_factory=ModelConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    sync: SyncConfig = field(default_factory=SyncConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    data: DataConfig = field(default_factory=DataConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    fault: FaultToleranceConfig = field(default_factory=FaultToleranceConfig)
    steps: int = 100
    log_every: int = 10
    remat: str = "none"            # none | full | dots  (activation ckpt policy)
    scan_layers: bool = True       # lax.scan over layer stack
    seed: int = 0


def replace(cfg, **kw):
    """``dataclasses.replace`` that also accepts dotted keys, e.g.
    ``replace(cfg, **{"sync.period": 32})``."""
    direct = {k: v for k, v in kw.items() if "." not in k}
    nested: dict = {}
    for k, v in kw.items():
        if "." in k:
            head, rest = k.split(".", 1)
            nested.setdefault(head, {})[rest] = v
    for head, sub in nested.items():
        direct[head] = replace(getattr(cfg, head), **sub)
    return dataclasses.replace(cfg, **direct)


def asdict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def config_fingerprint(cfg) -> str:
    """Stable hash for checkpoint compatibility checks (the reference's:
    equal configs give equal fingerprints in both packages)."""
    import hashlib
    import json

    blob = json.dumps(asdict(cfg), sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]
