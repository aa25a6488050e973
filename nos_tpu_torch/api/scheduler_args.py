"""Port of `nos_tpu/api/scheduler_args.py` (:1-154): `PluginArgsError` (:27),
`CapacitySchedulingArgs` (:38), `CapacitySchedulingArgsV1Beta3` (:49),
`set_defaults_capacity_v1beta3` (:91),
`convert_capacity_v1beta3_to_internal` (:100), `decode_plugin_args` (:128),
`encode_plugin_args` (:147). Copied verbatim; only the imports point at the
port, which imports nothing of the JAX package.

Versioned scheduler plugin-args (pkg/api/scheduler + v1beta3 analog).

The reference embeds typed plugin args in the kube-scheduler's
KubeSchedulerConfiguration: an external versioned type
(apiVersion `kubescheduler.config.k8s.io/v1beta3`, kind
`CapacitySchedulingArgs`, pointer fields — pkg/api/scheduler/v1beta3/
types.go) plus generated defaulting and conversion into an internal hub
type with value semantics (pkg/api/scheduler/types.go,
hack/generate-scheduler.sh). Same architecture, hand-rolled and
Python-idiomatic: a scheme REGISTRY keyed on (apiVersion, kind), strict
field checking on decode, SetDefaults-style fillers on the external shape,
and an explicit conversion into the internal type the scheduler consumes.
The versioning exists for the same reason as upstream's: a pluginConfig
document written for v1beta3 must keep decoding identically after the
internal type evolves — the external shape is the wire contract, the
internal one is not.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

from nos_tpu_torch import constants


class PluginArgsError(ValueError):
    pass


GROUP = "kubescheduler.config.k8s.io"
V1BETA3 = f"{GROUP}/v1beta3"
KIND_CAPACITY = "CapacitySchedulingArgs"


# -- internal hub type (value semantics; what the scheduler consumes) --------
@dataclass(frozen=True)
class CapacitySchedulingArgs:
    """pkg/api/scheduler/types.go CapacitySchedulingArgs, extended with the
    TPU chip memory the quota math meters TPU requests by (the reference is
    GPU-only here)."""

    nvidia_gpu_resource_memory_gb: float = constants.DEFAULT_GPU_MEMORY_GB
    tpu_chip_memory_gb: float = constants.DEFAULT_TPU_CHIP_MEMORY_GB


# -- external v1beta3 type (optional fields = Go pointers) --------------------
@dataclass
class CapacitySchedulingArgsV1Beta3:
    nvidia_gpu_resource_memory_gb: Optional[float] = None
    tpu_chip_memory_gb: Optional[float] = None

    # Wire field names, exactly the Go json tags (+ the TPU extension).
    _FIELDS = {
        "nvidiaGpuResourceMemoryGB": "nvidia_gpu_resource_memory_gb",
        "tpuChipMemoryGB": "tpu_chip_memory_gb",
    }

    @classmethod
    def from_doc(cls, doc: Mapping) -> "CapacitySchedulingArgsV1Beta3":
        args = cls()
        for key, value in doc.items():
            if key in ("apiVersion", "kind"):
                continue
            attr = cls._FIELDS.get(key)
            if attr is None:
                # Strict, like the loader for component configs: silently
                # dropped knobs are how misconfigurations ship.
                raise PluginArgsError(
                    f"unknown field {key!r} for {KIND_CAPACITY} {V1BETA3} "
                    f"(known: {sorted(cls._FIELDS)})"
                )
            # The reference wire type is *int64 (scheduler args codegen):
            # YAML booleans are a distinct type there, so `true` must be a
            # decode error — Python's bool subclasses int and float(True)
            # would silently yield 1.0. Strings are likewise rejected (the
            # YAML loader already gives numbers for numeric scalars; a
            # string reaching here is a quoted typo), and non-finite floats
            # (inf/nan survive float() untouched) fail the same check.
            import math

            if isinstance(value, bool) or not isinstance(value, (int, float)):
                raise PluginArgsError(f"field {key!r}: {value!r} is not a number")
            number = float(value)
            if not math.isfinite(number):
                raise PluginArgsError(f"field {key!r}: {value!r} is not finite")
            setattr(args, attr, number)
        return args


def set_defaults_capacity_v1beta3(args: CapacitySchedulingArgsV1Beta3) -> None:
    """SetDefaults_CapacitySchedulingArgs analog (zz_generated.defaults.go):
    fill unset pointers before conversion."""
    if args.nvidia_gpu_resource_memory_gb is None:
        args.nvidia_gpu_resource_memory_gb = constants.DEFAULT_GPU_MEMORY_GB
    if args.tpu_chip_memory_gb is None:
        args.tpu_chip_memory_gb = constants.DEFAULT_TPU_CHIP_MEMORY_GB


def convert_capacity_v1beta3_to_internal(
    ext: CapacitySchedulingArgsV1Beta3,
) -> CapacitySchedulingArgs:
    """zz_generated.conversions.go analog. Runs after defaulting, so every
    field is set; validation happens on the internal type."""
    internal = CapacitySchedulingArgs(
        nvidia_gpu_resource_memory_gb=float(ext.nvidia_gpu_resource_memory_gb),
        tpu_chip_memory_gb=float(ext.tpu_chip_memory_gb),
    )
    if internal.nvidia_gpu_resource_memory_gb <= 0:
        raise PluginArgsError("nvidiaGpuResourceMemoryGB must be positive")
    if internal.tpu_chip_memory_gb <= 0:
        raise PluginArgsError("tpuChipMemoryGB must be positive")
    return internal


def _decode_capacity_v1beta3(doc: Mapping) -> CapacitySchedulingArgs:
    ext = CapacitySchedulingArgsV1Beta3.from_doc(doc)
    set_defaults_capacity_v1beta3(ext)
    return convert_capacity_v1beta3_to_internal(ext)


# -- the scheme (register.go analog) -----------------------------------------
_SCHEME = {
    (V1BETA3, KIND_CAPACITY): _decode_capacity_v1beta3,
}


def decode_plugin_args(doc: Mapping) -> CapacitySchedulingArgs:
    """Decode one pluginConfig args document: dispatch on
    (apiVersion, kind), default, convert. Unknown group-versions or kinds
    fail loudly with the supported set — the scheme is the compatibility
    contract."""
    if not isinstance(doc, Mapping):
        raise PluginArgsError(f"plugin args must be a mapping, got {type(doc).__name__}")
    api_version = doc.get("apiVersion")
    kind = doc.get("kind")
    decoder = _SCHEME.get((api_version, kind))
    if decoder is None:
        known = sorted(f"{v}/{k}" for v, k in _SCHEME)
        raise PluginArgsError(
            f"no decoder for apiVersion={api_version!r} kind={kind!r}; "
            f"supported: {known}"
        )
    return decoder(doc)


def encode_plugin_args(args: CapacitySchedulingArgs) -> dict:
    """Round-trip encoder (external v1beta3 shape), for tooling and tests."""
    return {
        "apiVersion": V1BETA3,
        "kind": KIND_CAPACITY,
        "nvidiaGpuResourceMemoryGB": args.nvidia_gpu_resource_memory_gb,
        "tpuChipMemoryGB": args.tpu_chip_memory_gb,
    }
