"""The hand-rolled deepcopy() methods of the port's object model
(`nos_tpu_torch/api/objects.py`) against the JAX package's: the cases of
tests/test_objects_deepcopy.py on both packages (every dataclass field
auto-populated by reflection, so a field a deepcopy() drops or aliases
fails), and a populated object of each kind equal field for field across
packages."""

from __future__ import annotations

import copy
import dataclasses
import importlib
import typing

import pytest

PACKAGES = ("nos_tpu", "nos_tpu_torch")
COPYABLE = ("Pod", "Node", "ConfigMap", "PodDisruptionBudget", "Lease")


def populate(pkg, name):
    """An instance of `pkg`'s class `name` with every field set to a
    distinctive value; the same values in either package."""
    objects = importlib.import_module(f"{pkg}.api.objects")
    ResourceList = importlib.import_module(f"{pkg}.api.resources").ResourceList
    counter = [0]

    def fresh(t, name):
        counter[0] += 1
        n = counter[0]
        origin = typing.get_origin(t)
        if origin is typing.Union:  # Optional[X]
            args = [a for a in typing.get_args(t) if a is not type(None)]
            return fresh(args[0], name)
        if t is str:
            return f"{name}-{n}"
        if t is int:
            return 100 + n
        if t is float:
            return 0.5 + n
        if t is bool:
            return True
        if t is ResourceList:
            return ResourceList({f"res-{name}": float(n)})
        if origin in (dict, typing.Dict):
            kt, vt = typing.get_args(t)
            return {fresh(kt, name + "k"): fresh(vt, name + "v")}
        if origin in (list, typing.List):
            (et,) = typing.get_args(t)
            return [fresh(et, name + "e"), fresh(et, name + "e")]
        if dataclasses.is_dataclass(t):
            return build(t)
        raise AssertionError(f"unhandled field type {t!r} for {name}")

    def build(cls):
        hints = typing.get_type_hints(cls)
        return cls(**{f.name: fresh(hints[f.name], f.name) for f in dataclasses.fields(cls)})

    return build(getattr(objects, name))


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("name", COPYABLE)
def test_deepcopy_preserves_every_field(pkg, name):
    obj = populate(pkg, name)
    assert obj.deepcopy() == copy.deepcopy(obj), (
        f"{name}.deepcopy() drops or mangles a field — it must be "
        f"updated for newly added fields"
    )


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("name", COPYABLE)
def test_deepcopy_does_not_alias(pkg, name):
    obj = populate(pkg, name)
    dup = obj.deepcopy()

    def scramble(o):
        for f in dataclasses.fields(o):
            v = getattr(o, f.name)
            if isinstance(v, dict):
                v["__scrambled__"] = "yes"
            elif isinstance(v, list):
                v.append("__scrambled__")
            elif dataclasses.is_dataclass(v):
                scramble(v)

    snapshot = copy.deepcopy(obj)
    scramble(dup)
    assert obj == snapshot, f"{name}.deepcopy() aliases a container"


@pytest.mark.parametrize("pkg", PACKAGES)
def test_every_kinded_object_is_guarded(pkg):
    """Any new KIND-carrying object must join COPYABLE above."""
    objects = importlib.import_module(f"{pkg}.api.objects")
    kinded = {
        cls.__name__
        for cls in vars(objects).values()
        if dataclasses.is_dataclass(cls) and hasattr(cls, "KIND")
    }
    assert kinded == set(COPYABLE)


@pytest.mark.parametrize("name", COPYABLE)
def test_populated_objects_equal_across_packages(name):
    """The same reflection gives the same field names, types and values in
    both packages (the classes differ, so compare as dicts)."""
    want = populate("nos_tpu", name)
    got = populate("nos_tpu_torch", name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.deepcopy()) == dataclasses.asdict(want.deepcopy())
