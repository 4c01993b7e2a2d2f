"""The model zoo's configs in the port against the JAX package, on the
CPU: the port's own copy of the configs equals ``repro.configs`` field by
field, and so do the shapes and the runnable cells; the model kernels'
wrappers read TMA's rules and strides right and refuse other devices. The
kernels' plain versions are held to the reference's kernel and oracle in
``test_torch_model_kernels_{rmsnorm,flash,flash_variants}.py``, on inputs
made with numpy from a seed by the helpers here."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per test process)
from repro.configs import base as jbase
from repro.configs.registry import ARCHS as JARCHS
from repro_torch import configs
from repro_torch.configs import base as tbase
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_cuda, kernel_strides, tma_readable,
)
from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_cuda

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(a, dtype):
    """The same numpy values as a JAX array and a torch tensor of
    ``dtype`` (both round f32 to bf16 to nearest even)."""
    return jnp.asarray(a).astype(JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(JARCHS))
def test_configs_equal_reference(name):
    j, t = JARCHS[name], configs.get_arch(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert (t.head_dim, t.is_subquadratic, t.has_decoder) == (
        j.head_dim, j.is_subquadratic, j.has_decoder)
    module = name.replace(".", "_").replace("-", "_")
    port_mod = __import__(f"repro_torch.configs.{module}", fromlist=["CONFIG"])
    assert port_mod.CONFIG == t


def test_shapes_and_runnable_cells_equal_reference():
    assert [dataclasses.asdict(s) for s in tbase.SHAPES] == [
        dataclasses.asdict(s) for s in jbase.SHAPES]
    assert [f.name for f in dataclasses.fields(tbase.ArchConfig)] == [
        f.name for f in dataclasses.fields(jbase.ArchConfig)]
    for name in sorted(JARCHS):
        for js, ts in zip(jbase.SHAPES, tbase.SHAPES):
            assert tbase.cell_is_runnable(configs.ARCHS[name], ts) == \
                jbase.cell_is_runnable(JARCHS[name], js)
            assert ts.is_decode == js.is_decode
    with pytest.raises(KeyError):
        configs.get_arch("no-such-arch")


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _bhsd(a):
    """(B, S, H, D) -> the reference kernel's (B*H, S, D)."""
    b, s, h, d = a.shape
    return a.transpose(0, 2, 1, 3).reshape(b * h, s, d)


def test_tma_readability_and_kernel_strides():
    """Where the bf16 wrapper reads a tensor in place (TMA's 16-byte rules)
    and which strides it hands the kernel."""
    qkv = torch.zeros((2, 5, 12, 64), dtype=torch.bfloat16)
    k = qkv[:, :, 8:10]                       # a fused projection's view
    assert tma_readable(k) and kernel_strides(k) == [3840, 768, 64]
    flat = torch.zeros(2 * 5 * 4 * 64 + 1, dtype=torch.bfloat16)
    assert not tma_readable(flat[1:].view(2, 5, 4, 64))   # base off by 2 B
    assert not tma_readable(torch.zeros((1, 4, 2, 12),
                                        dtype=torch.bfloat16)[..., :8])
    assert not tma_readable(qkv.transpose(2, 3)[..., :8])  # D strided
    one = torch.zeros((1, 1, 4, 16), dtype=torch.bfloat16)
    assert tma_readable(one) and kernel_strides(one) == [64, 64, 16]
    odd = torch.zeros((1, 3, 1, 16), dtype=torch.bfloat16).as_strided(
        (1, 3, 1, 16), (7, 16, 5, 1))         # size-1 strides never used
    assert tma_readable(odd) and kernel_strides(odd) == [48, 16, 16]


def test_wrappers_refuse_other_devices():
    """A tensor neither on the CPU nor on a CUDA device has no route."""
    x = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel route"):
        rmsnorm_cuda(x, torch.empty(8, device="meta"))
    q = torch.empty((1, 4, 2, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel route"):
        flash_attention_cuda(q, q, q)
