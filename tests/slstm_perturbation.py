"""How far a 1e-6 relative change of its input moves one sLSTM block at
``xlstm-1.3b``'s published widths (d_model 2,048, 4 heads), in the JAX
package and in the port, on the CPU.

Both get the same f32 weights (the reference's initialisation, key 0) and
the same N(0, 1) input of B = 2 x S = 512 from numpy (seed 0); the
perturbed input multiplies each element by 1 + 1e-6 n, n ~ N(0, 1) (seed
1). The block keeps its own bf16 cast of the hidden state at each step
(``DTYPE``), in both packages. Prints, at a few positions, the relative RMS
change of the block's output (over the batch and the width) and the
largest over all positions.

Run from the repository root (about a minute):

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/slstm_perturbation.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_parity
from repro.configs.registry import get_arch as jget_arch
from repro.models import layers as JL
from repro.models import ssm as JS
from repro_torch.configs.registry import get_arch
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS

ARCH = "xlstm-1.3b"
B, S, REL = 2, 512, 1e-6
POSITIONS = (0, 15, 63, 127, 255, 383, 511)


def relative_change(y, y2):
    """(S,) RMS over batch and width of ``y2 - y`` over that of ``y``."""
    return (np.sqrt(((y2 - y) ** 2).mean(axis=(0, 2)))
            / np.sqrt((y ** 2).mean(axis=(0, 2))))


def main():
    jcfg, tcfg = jget_arch(ARCH), get_arch(ARCH)
    with torch_parity.quick_compiles():
        jp = JS.init_slstm(jcfg, JL.Init(jax.random.PRNGKey(0)))
    w = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    x = np.random.default_rng(0).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    x2 = x * (1 + REL * np.random.default_rng(1).standard_normal(
        x.shape).astype(np.float32))

    jw = jax.tree.map(jnp.asarray, w)
    fwd = jax.jit(lambda a: JS.slstm_forward(jcfg, jw, a))
    with torch_parity.quick_compiles():
        jy, jy2 = (np.asarray(fwd(jnp.asarray(a)), np.float32)
                   for a in (x, x2))

    tw = TS.SLSTM(TL.Dense(torch.from_numpy(w["w_in"]["w"])),
                  torch.from_numpy(w["r"]), torch.from_numpy(w["out_norm"]),
                  TL.Dense(torch.from_numpy(w["proj"]["w"])))
    with torch.inference_mode():
        ty, ty2 = (TS.slstm_forward(tcfg, tw, torch.from_numpy(a))
                   .float().numpy() for a in (x, x2))

    print(f"{ARCH} sLSTM block, f32 weights, B={B} x S={S}: relative RMS "
          f"change of the output after a {REL:g} relative change of the "
          "input")
    for name, y, y2 in (("JAX package", jy, jy2), ("port", ty, ty2)):
        r = relative_change(y, y2)
        print(f"  {name}: " + ", ".join(
            f"position {p} {r[p]:.3g}" for p in POSITIONS)
            + f"; largest {r.max():.3g} (position {int(r.argmax())})")
    print(f"  port against the JAX package, unperturbed: relative RMS "
          f"{float(np.sqrt(((ty - jy) ** 2).mean() / (jy ** 2).mean())):.3g}")


if __name__ == "__main__":
    main()
