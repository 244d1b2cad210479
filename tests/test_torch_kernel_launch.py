"""The launch layer of the port's CUDA libraries (``kernels/_build.py``), on
the CPU: nothing here loads or builds a library.

- Every library's declared entry signatures match the ``extern "C"``
  functions of its ``csrc/`` source: the same entries, the same number of
  parameters, and each parameter a pointer, an array of pointers or an int
  as declared (a wrong list shows up on the card only as a crash or wrong
  bits).
- The shared tensor check refuses a tensor on another device, of another
  dtype or shape, or not contiguous, naming it; ``cuda_device`` refuses a
  CPU tensor.
- Every kernel module counts launches under the keys it always has, and
  resets them.
"""

from __future__ import annotations

import re

import pytest
import torch

from celeste_tpu_torch.kernels import (
    mog_field,
    mog_field_sep,
    scene_planes,
    scene_prior,
    tiled_field,
)
from celeste_tpu_torch.kernels._build import CSRC_DIR, check_tensor, cuda_device

MODULES = {m.LIBRARY.name: m for m in (mog_field, mog_field_sep, tiled_field, scene_planes,
                                        scene_prior)}

COUNTERS = {
    "mog_field": ["mog_field_loglik_fwd", "mog_field_loglik_bwd", "mog_field_render"],
    "mog_field_sep": ["mog_field_sep_fwd", "mog_field_sep_bwd"],
    "tiled_field": ["tiled_field_fwd", "tiled_field_fwd_lam", "tiled_field_bwd",
                    "tiled_field_render", "tiled_field_render_bwd"],
    "scene_planes": ["scene_planes_fwd", "scene_planes_bwd"],
    "scene_prior": ["scene_prior_fwd", "scene_prior_bwd"],
}


def _extern_c_functions(source: str) -> dict[str, tuple[str, list[str]]]:
    """{name: (return type, [parameter declarations])} of the functions
    defined in the ``extern "C"`` blocks of a CUDA source."""
    out = {}
    for block in re.findall(r'extern "C" \{(.*?)\n\}  // extern "C"', source, re.S):
        block = re.sub(r"//[^\n]*", "", block)
        for ret, name, params in re.findall(
                r"^((?:const\s+)?\w+\s*\*?)\s*(\w+)\s*\(([^)]*)\)\s*\{", block, re.M):
            out[name] = (" ".join(ret.split()), [p.strip() for p in params.split(",")])
    return out


def _letter(param: str) -> str:
    """A C parameter declaration as a signature letter."""
    stars = param.count("*")
    if stars == 2:
        return "a"
    if stars == 1:
        return "p"
    assert re.fullmatch(r"int\s+\w+", param), param
    return "i"


CASES = [(name, entry) for name, m in MODULES.items() for entry in m.LIBRARY.entries]


def test_every_library_and_entry_is_covered():
    assert sorted(MODULES) == sorted(COUNTERS)
    assert len(CASES) == 13


@pytest.mark.parametrize("name", sorted(MODULES))
def test_the_declared_entries_are_the_sources_entries(name):
    lib = MODULES[name].LIBRARY
    found = {}
    for src in lib.sources:
        found.update(_extern_c_functions((CSRC_DIR / src).read_text()))
    assert sorted(found) == sorted([*lib.entries, f"{name}_error_string"])
    assert found[f"{name}_error_string"] == ("const char*", ["int err"])
    for entry in lib.entries:
        assert found[entry][0] == "int", entry


@pytest.mark.parametrize("name,entry", CASES)
def test_declared_signature_matches_the_source(name, entry):
    lib = MODULES[name].LIBRARY
    found = {}
    for src in lib.sources:
        found.update(_extern_c_functions((CSRC_DIR / src).read_text()))
    params = found[entry][1]
    assert params[-1] == "void* stream", entry
    assert "".join(_letter(p) for p in params) == lib.entries[entry]


@pytest.mark.parametrize("name", sorted(MODULES))
def test_launch_counters_keep_their_keys_and_reset(name):
    m = MODULES[name]
    assert list(m.launch_counts()) == COUNTERS[name]
    m.LIBRARY.counts[COUNTERS[name][0]] += 2
    counts = m.launch_counts()
    assert counts[COUNTERS[name][0]] >= 2
    counts[COUNTERS[name][0]] = -1                     # a copy: the library's stay
    assert m.launch_counts()[COUNTERS[name][0]] >= 2
    m.reset_launch_counts()
    assert set(m.launch_counts().values()) == {0}


def _refusals():
    t = torch.zeros(4, 6)
    return {
        "device": (t.to("meta"), "x on meta, expected cpu"),
        "dtype": (t.double(), "x has dtype torch.float64, expected torch.float32"),
        "shape": (t[:, :5], r"x has shape \(4, 5\), expected \(4, 6\)"),
        "contiguous": (t.t().contiguous().t(), "x is not contiguous"),
    }


@pytest.mark.parametrize("case", ["device", "dtype", "shape", "contiguous"])
def test_tensor_check_refuses(case):
    bad, message = _refusals()[case]
    with pytest.raises(ValueError, match=message):
        check_tensor(bad, "x", (4, 6), torch.device("cpu"))


def test_tensor_check_takes_a_good_tensor_and_an_int32_table():
    check_tensor(torch.zeros(4, 6), "x", (4, 6), torch.device("cpu"))
    check_tensor(torch.zeros(3, dtype=torch.int32), "t", torch.Size([3]), torch.device("cpu"),
                 torch.int32)
    with pytest.raises(ValueError, match="dtype"):
        check_tensor(torch.zeros(3), "t", (3,), torch.device("cpu"), torch.int32)


def test_cuda_device_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors, got cpu"):
        cuda_device(torch.zeros(2))
