"""The seams of the port's CUDA sources (``witw_tpu_torch/csrc``), read as
text on the CPU:

- ``hopper.cuh`` holds the plumbing every kernel library shares (PTX
  wrappers, the persistent grid, the shared-memory attribute, the error
  string): each source includes it, directly or through
  ``int8_wgmma.cuh``, and defines none of its functions, and none sets the
  dynamic shared-memory attribute or reads the occupancy itself;
- ``kernels/build.library_path`` names a library by its own source and the
  headers: an edit to another kernel leaves its name, an edit to its source
  or to a header changes it.
"""

import torch_workers  # noqa: F401  (first: the workers' thread budget)

import re
import shutil

import pytest

from witw_tpu_torch.kernels import build

CSRC = build.CSRC_DIR
HEADER = "hopper.cuh"
KEYWORDS = {"if", "for", "while", "switch", "return", "sizeof", "catch", "constexpr"}
# Decisions made once, in hopper.cuh: the dynamic shared-memory attribute and
# the persistent grid's occupancy and SM count.
HEADER_ONLY = ("cudaFuncAttributeMaxDynamicSharedMemorySize",
               "cudaOccupancyMaxActiveBlocksPerMultiprocessor", "cudaDevAttrMultiProcessorCount")


def _code(text: str) -> str:
    """The source without comments and string literals."""
    return re.sub(r'//[^\n]*|/\*.*?\*/|"(?:\\.|[^"\\\n])*"', " ", text, flags=re.S)


def _defined(text: str) -> set:
    """Names of the functions the source defines: a name, its parameters
    and the opening brace of a body."""
    found = re.findall(r"\b([A-Za-z_]\w*)\s*\((?:[^()]|\([^()]*\))*\)\s*(?:const\s*)?\{", _code(text))
    return set(found) - KEYWORDS


def _includes(name: str) -> set:
    """The csrc headers ``name`` includes, directly or through another."""
    seen, todo = set(), [name]
    while todo:
        for inc in re.findall(r'^#include "([^"]+)"', (CSRC / todo.pop()).read_text(), flags=re.M):
            if inc not in seen:
                seen.add(inc)
                todo.append(inc)
    return seen


SOURCES = sorted(p.name for p in CSRC.glob("*.cu*") if p.name != HEADER)


def test_header_defines_the_shared_helpers():
    got = _defined((CSRC / HEADER).read_text())
    want = {"smem_addr", "mbar_init", "mbar_arrive", "mbar_arrive_expect_tx", "mbar_wait",
            "cp_async16", "cp_async_commit", "cp_async_wait", "bulk_copy", "fence_proxy_async",
            "wgmma_fence", "wgmma_commit", "wgmma_wait", "desc", "lds128", "sts128",
            "fence_operand", "persistent_grid", "set_smem", "witw_cuda_error_string"}
    assert want <= got, sorted(want - got)


@pytest.mark.parametrize("name", SOURCES)
def test_source_shares_the_header(name):
    text = (CSRC / name).read_text()
    assert HEADER in _includes(name)
    again = _defined(text) & _defined((CSRC / HEADER).read_text())
    assert not again, f"{name} defines hopper.cuh's {sorted(again)}"
    assert not [s for s in HEADER_ONLY if s in _code(text)]


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(CSRC, copy)
    monkeypatch.setattr(build, "CSRC_DIR", copy)
    return copy


@pytest.mark.parametrize("edited,rebuilds", [("conv3x3_bf16.cu", False), ("maxpool.cu", True),
                                             ("hopper.cuh", True), ("int8_wgmma.cuh", True)])
def test_library_name_follows_its_sources(csrc_copy, edited, rebuilds):
    before = build.library_path("maxpool")
    with open(csrc_copy / edited, "a") as f:
        f.write("\n// edited\n")
    assert (build.library_path("maxpool") != before) == rebuilds
    assert build.library_path("maxpool").parent == build.BUILD_DIR
