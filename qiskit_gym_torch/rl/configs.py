"""Algorithm / policy configuration dataclasses.

Flat kwargs-first dataclasses that serialize to (and load from) the nested
JSON schema of the reference checkpoints (examples/models/*.json:
collecting/training/learning/optimizer/evals/logging, with gae_lambda named
"lambda" in JSON) so configs round-trip byte-compatibly. Defaults match the
reference (reference rl/configs.py:133-165, 354-386, 556-562, 645-652).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Mapping


@dataclass
class EvalConfig:
    """One named evaluation preset.

    num_searches: independent whole-episode rollouts per target, keep best.
    num_mcts_searches: MCTS simulations per decision (stacks with searches).
    num_cores: kept for config-file compatibility; on TPU the batch is
    device-wide and this knob is ignored.
    """

    num_episodes: int = 100
    deterministic: bool = True
    num_searches: int = 1
    num_mcts_searches: int = 0
    num_cores: int = 32
    C: float = 1.41

    def validate(self) -> None:
        if self.num_episodes <= 0 or self.num_searches <= 0:
            raise ValueError("EvalConfig episode/search counts must be > 0")
        if self.num_mcts_searches < 0 or self.C <= 0 or self.num_cores <= 0:
            raise ValueError("EvalConfig: bad num_mcts_searches/C/num_cores")

    @classmethod
    def from_partial(cls, data: Mapping[str, Any] | None) -> "EvalConfig":
        data = dict(data or {})
        kwargs = {f: data[f] for f in cls.__dataclass_fields__ if f in data}
        return cls(**kwargs)


def _default_ppo_evals() -> Dict[str, EvalConfig]:
    return {
        "ppo_deterministic": EvalConfig(),
        "ppo_10": EvalConfig(deterministic=False, num_searches=10),
    }


def _default_az_evals() -> Dict[str, EvalConfig]:
    out = _default_ppo_evals()
    out["mcts_100"] = EvalConfig(deterministic=True, num_searches=1,
                                 num_mcts_searches=100)
    return out


class _JsonMixin:
    def with_updates(self, **kwargs):
        return replace(self, **kwargs)

    def _common_validate(self):
        if self.num_episodes <= 0 or self.num_epochs <= 0:
            raise ValueError("num_episodes and num_epochs must be > 0")
        if not (0.0 <= self.diff_threshold <= 1.0):
            raise ValueError("diff_threshold must be in [0, 1]")
        if self.diff_max < 1:
            raise ValueError("diff_max must be >= 1")
        if self.diff_metric not in self.evals:
            raise ValueError(
                f"diff_metric {self.diff_metric!r} not in evals "
                f"{list(self.evals.keys())}"
            )
        for name, ev in self.evals.items():
            try:
                ev.validate()
            except Exception as exc:
                raise ValueError(f"Invalid eval {name!r}: {exc}") from exc

    def _tail_json(self) -> dict:
        return {
            "learning": {
                "diff_threshold": self.diff_threshold,
                "diff_max": self.diff_max,
                "diff_metric": self.diff_metric,
            },
            "optimizer": {"lr": self.lr},
            "evals": {k: vars(v) for k, v in self.evals.items()},
            "logging": {
                "log_freq": self.log_freq,
                "checkpoint_freq": self.checkpoint_freq,
            },
        }

    @classmethod
    def _tail_from_json(cls, data: Mapping[str, Any]) -> dict:
        learning = data.get("learning", {})
        evals = dict(cls().evals)
        for name, partial in data.get("evals", {}).items():
            evals[name] = EvalConfig.from_partial(partial)
        return {
            "diff_threshold": learning.get("diff_threshold", cls.diff_threshold),
            "diff_max": learning.get("diff_max", cls.diff_max),
            "diff_metric": learning.get("diff_metric", cls.diff_metric),
            "lr": data.get("optimizer", {}).get("lr", cls.lr),
            "log_freq": data.get("logging", {}).get("log_freq", cls.log_freq),
            "checkpoint_freq": data.get("logging", {}).get(
                "checkpoint_freq", cls.checkpoint_freq
            ),
            "evals": evals,
        }


@dataclass
class PPOConfig(_JsonMixin):
    # collection
    num_cores: int = 32          # compat knob; TPU ignores it (batch = device-wide)
    num_episodes: int = 1024
    gae_lambda: float = 0.995
    gamma: float = 0.995
    # episode packing: finished lanes are refilled mid-rollout from a pool of
    # pool_slots pregenerated reset batches (rl/rollout.collect_packed) —
    # every scan step collects useful data instead of freezing finished
    # lanes. Off by default (aligned collection, reference semantics).
    episode_packing: bool = False
    pack_pool_slots: int = 8
    # curriculum replay: mix lanes from the diff_replay most recent
    # difficulties into every collection batch (half the lanes stay at the
    # frontier) — keeps dense learning signal when frontier success is low
    # (docs/TRAINING.md). 0 = off (reference semantics).
    diff_replay: int = 0
    # training
    num_epochs: int = 10
    # gradient steps per epoch: 1 = one full-batch update (reference
    # semantics); k > 1 shuffles the [T*B] transitions into k minibatches
    # per epoch — more optimization steps per collected batch, the standard
    # PPO recipe for large on-device batches
    num_minibatches: int = 1
    vf_coef: float = 0.8
    ent_coef: float = 0.01
    clip_ratio: float = 0.1
    normalize_advantage: bool = False
    # optimizer
    lr: float = 3e-4
    # curriculum
    diff_threshold: float = 0.85
    diff_max: int = 256
    diff_metric: str = "ppo_deterministic"
    # evals & logging
    evals: Dict[str, EvalConfig] = field(default_factory=_default_ppo_evals)
    log_freq: int = 1
    checkpoint_freq: int = 10
    # constant
    algorithm_cls: str = "qiskit_gym_torch.rl.PPO"

    def validate(self) -> None:
        self._common_validate()
        if not (0.0 <= self.gae_lambda <= 1.0) or not (0.0 <= self.gamma <= 1.0):
            raise ValueError("gae_lambda and gamma must be in [0, 1]")
        if self.clip_ratio <= 0:
            raise ValueError("clip_ratio must be > 0")
        if self.pack_pool_slots < 1 or self.num_minibatches < 1:
            raise ValueError(
                "pack_pool_slots and num_minibatches must be >= 1")
        if self.diff_replay < 0:
            raise ValueError("diff_replay must be >= 0")

    def to_json(self) -> dict:
        self.validate()
        out = {
            "collecting": {
                "num_cores": self.num_cores,
                "num_episodes": self.num_episodes,
                "lambda": self.gae_lambda,
                "gamma": self.gamma,
            },
            "training": {
                "num_epochs": self.num_epochs,
                "vf_coef": self.vf_coef,
                "ent_coef": self.ent_coef,
                "clip_ratio": self.clip_ratio,
                "normalize_advantage": self.normalize_advantage,
            },
        }
        # packing/minibatch knobs are emitted only when changed, keeping
        # configs written with defaults byte-identical to the reference schema
        for k in ("episode_packing", "pack_pool_slots", "diff_replay"):
            if getattr(self, k) != getattr(type(self), k):
                out["collecting"][k] = getattr(self, k)
        if self.num_minibatches != type(self).num_minibatches:
            out["training"]["num_minibatches"] = self.num_minibatches
        out.update(self._tail_json())
        return out

    @classmethod
    def from_json(cls, data: Mapping[str, Any]) -> "PPOConfig":
        col = data.get("collecting", {})
        tr = data.get("training", {})
        obj = cls(
            num_cores=col.get("num_cores", cls.num_cores),
            num_episodes=col.get("num_episodes", cls.num_episodes),
            gae_lambda=col.get("lambda", cls.gae_lambda),
            gamma=col.get("gamma", cls.gamma),
            episode_packing=col.get("episode_packing", cls.episode_packing),
            pack_pool_slots=col.get("pack_pool_slots", cls.pack_pool_slots),
            diff_replay=col.get("diff_replay", cls.diff_replay),
            num_epochs=tr.get("num_epochs", cls.num_epochs),
            num_minibatches=tr.get("num_minibatches", cls.num_minibatches),
            vf_coef=tr.get("vf_coef", cls.vf_coef),
            ent_coef=tr.get("ent_coef", cls.ent_coef),
            clip_ratio=tr.get("clip_ratio", cls.clip_ratio),
            normalize_advantage=tr.get("normalize_advantage", cls.normalize_advantage),
            algorithm_cls=data.get("algorithm_cls", cls.algorithm_cls),
            **cls._tail_from_json(data),
        )
        obj.validate()
        return obj


@dataclass
class AlphaZeroConfig(_JsonMixin):
    # collection (self-play)
    num_cores: int = 32
    num_episodes: int = 128
    num_mcts_searches: int = 1000
    C: float = 1.41
    max_expand_depth: int = 1
    # episode packing: finished lanes are refilled mid-rollout from a pool
    # of pregenerated reset batches (rl/az.collect_mcts_packed), so every
    # scan step runs a useful MCTS decision instead of freezing finished
    # lanes. Off by default (aligned collection, reference semantics).
    episode_packing: bool = False
    pack_pool_slots: int = 8
    # curriculum replay (see PPOConfig.diff_replay); 0 = off
    diff_replay: int = 0
    # self-play exploration (AZ conventions; defaults keep the legacy
    # no-noise behavior and are omitted from JSON when left at defaults)
    root_noise_eps: float = 0.0     # Dirichlet noise fraction at the root
    dirichlet_alpha: float = 0.3
    temperature: float = 1.0        # visit-count sampling temperature
    temperature_drop: int = 0       # argmax after this many moves (0 = never)
    # training
    num_epochs: int = 10
    # gradient steps per epoch: 1 = one full-batch update (reference
    # semantics); k > 1 shuffles the [T*B] transitions into k minibatches
    # per epoch (same recipe that unlocked large-action-space PPO training,
    # docs/TRAINING.md)
    num_minibatches: int = 1
    # optimizer
    lr: float = 3e-4
    # curriculum
    diff_threshold: float = 0.85
    diff_max: int = 256
    diff_metric: str = "mcts_100"
    # evals & logging
    evals: Dict[str, EvalConfig] = field(default_factory=_default_az_evals)
    log_freq: int = 1
    checkpoint_freq: int = 10
    # constant
    algorithm_cls: str = "qiskit_gym_torch.rl.AZ"

    def validate(self) -> None:
        self._common_validate()
        if self.num_mcts_searches <= 0 or self.C <= 0 or self.max_expand_depth < 1:
            raise ValueError("bad num_mcts_searches / C / max_expand_depth")
        if not (0.0 <= self.root_noise_eps <= 1.0) or self.dirichlet_alpha <= 0:
            raise ValueError("bad root_noise_eps / dirichlet_alpha")
        if self.temperature <= 0 or self.temperature_drop < 0:
            raise ValueError("bad temperature / temperature_drop")
        if self.pack_pool_slots < 1 or self.num_minibatches < 1:
            raise ValueError(
                "pack_pool_slots and num_minibatches must be >= 1")
        if self.diff_replay < 0:
            raise ValueError("diff_replay must be >= 0")

    def to_json(self) -> dict:
        self.validate()
        out = {
            "collecting": {
                "num_cores": self.num_cores,
                "num_episodes": self.num_episodes,
                "num_mcts_searches": self.num_mcts_searches,
                "C": self.C,
                "max_expand_depth": self.max_expand_depth,
            },
            "training": {"num_epochs": self.num_epochs},
        }
        # exploration/packing knobs are emitted only when changed, keeping
        # configs written with defaults byte-identical to the reference schema
        for k in ("root_noise_eps", "dirichlet_alpha", "temperature",
                  "temperature_drop", "episode_packing", "pack_pool_slots",
                  "diff_replay"):
            if getattr(self, k) != getattr(type(self), k):
                out["collecting"][k] = getattr(self, k)
        if self.num_minibatches != type(self).num_minibatches:
            out["training"]["num_minibatches"] = self.num_minibatches
        out.update(self._tail_json())
        return out

    @classmethod
    def from_json(cls, data: Mapping[str, Any]) -> "AlphaZeroConfig":
        col = data.get("collecting", {})
        tr = data.get("training", {})
        obj = cls(
            num_cores=col.get("num_cores", cls.num_cores),
            num_episodes=col.get("num_episodes", cls.num_episodes),
            num_mcts_searches=col.get("num_mcts_searches", cls.num_mcts_searches),
            C=col.get("C", cls.C),
            max_expand_depth=col.get("max_expand_depth", cls.max_expand_depth),
            root_noise_eps=col.get("root_noise_eps", cls.root_noise_eps),
            dirichlet_alpha=col.get("dirichlet_alpha", cls.dirichlet_alpha),
            temperature=col.get("temperature", cls.temperature),
            temperature_drop=col.get("temperature_drop", cls.temperature_drop),
            episode_packing=col.get("episode_packing", cls.episode_packing),
            pack_pool_slots=col.get("pack_pool_slots", cls.pack_pool_slots),
            diff_replay=col.get("diff_replay", cls.diff_replay),
            num_epochs=tr.get("num_epochs", cls.num_epochs),
            num_minibatches=tr.get("num_minibatches", cls.num_minibatches),
            algorithm_cls=data.get("algorithm_cls", cls.algorithm_cls),
            **cls._tail_from_json(data),
        )
        obj.validate()
        return obj


ALGORITHMS = {"AZ": AlphaZeroConfig, "PPO": PPOConfig}


def _check_layers(layers: List[int], name: str) -> None:
    if not isinstance(layers, list) or any(
        (not isinstance(x, int)) or x < 1 for x in layers
    ):
        raise ValueError(f"{name} must be a list of ints >= 1 (got {layers!r})")


@dataclass
class BasicPolicyConfig:
    embedding_size: int = 512
    common_layers: List[int] = field(default_factory=lambda: [256])
    policy_layers: List[int] = field(default_factory=list)
    value_layers: List[int] = field(default_factory=list)
    policy_cls: str = "qiskit_gym_torch.models.BasicPolicy"

    def validate(self) -> None:
        if self.embedding_size < 1:
            raise ValueError("embedding_size must be >= 1")
        for name in ("common_layers", "policy_layers", "value_layers"):
            _check_layers(getattr(self, name), name)

    def with_updates(self, **kwargs) -> "BasicPolicyConfig":
        return replace(self, **kwargs)

    def to_json(self) -> dict:
        self.validate()
        return {
            "embedding_size": self.embedding_size,
            "common_layers": list(self.common_layers),
            "policy_layers": list(self.policy_layers),
            "value_layers": list(self.value_layers),
        }

    @classmethod
    def from_json(cls, data: Mapping[str, Any]) -> "BasicPolicyConfig":
        obj = cls(
            embedding_size=int(data.get("embedding_size", cls.embedding_size)),
            common_layers=list(data.get("common_layers", cls().common_layers)),
            policy_layers=list(data.get("policy_layers", cls().policy_layers)),
            value_layers=list(data.get("value_layers", cls().value_layers)),
            policy_cls=data.get("policy_cls", cls.policy_cls),
        )
        obj.validate()
        return obj


@dataclass
class Conv1dPolicyConfig:
    conv_dim: int = 1
    embedding_size: int = 1260
    common_layers: List[int] = field(default_factory=lambda: [256])
    policy_layers: List[int] = field(default_factory=list)
    value_layers: List[int] = field(default_factory=list)
    policy_cls: str = "qiskit_gym_torch.models.Conv1dPolicy"

    with_updates = BasicPolicyConfig.with_updates

    def validate(self):
        BasicPolicyConfig.validate(self)
        if self.conv_dim not in (0, 1):
            raise ValueError(f"conv_dim must be 0 or 1, got {self.conv_dim}")

    def to_json(self) -> dict:
        self.validate()
        return {
            "conv_dim": self.conv_dim,
            "embedding_size": self.embedding_size,
            "common_layers": list(self.common_layers),
            "policy_layers": list(self.policy_layers),
            "value_layers": list(self.value_layers),
        }

    @classmethod
    def from_json(cls, data: Mapping[str, Any]) -> "Conv1dPolicyConfig":
        obj = cls(
            conv_dim=int(data.get("conv_dim", cls.conv_dim)),
            embedding_size=int(data.get("embedding_size", cls.embedding_size)),
            common_layers=list(data.get("common_layers", cls().common_layers)),
            policy_layers=list(data.get("policy_layers", cls().policy_layers)),
            value_layers=list(data.get("value_layers", cls().value_layers)),
            policy_cls=data.get("policy_cls", cls.policy_cls),
        )
        obj.validate()
        return obj


POLICIES = {"BasicPolicy": BasicPolicyConfig, "Conv1dPolicy": Conv1dPolicyConfig}
