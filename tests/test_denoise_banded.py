"""atrous_denoise_banded == atrous_denoise (up to fusion rounding).

The sequential row-band a-trous serves frames the pipeline renders in
row bands (render/pipeline.auto_bands); the banded form reads every tap
the whole-frame form reads (each level's halo is its exact tap reach,
2*step; out-of-image taps carry weight 0 in both). The only residual difference is XLA FMA-contraction rounding
at the different program boundaries - ULP-level (~2e-7 observed), so
the check is allclose at 1e-5, not bitwise (the denoiser is a post
filter, not part of the bit-exact RNG-replay path).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_raytracer.ops import denoise


def _inputs(h, w, seed=3):
    rng = np.random.default_rng(seed)
    hdr = rng.exponential(0.3, (h, w, 3)).astype(np.float32)
    albedo = rng.uniform(0.05, 1.0, (h, w, 3)).astype(np.float32)
    n = rng.standard_normal((h, w, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    # valid octahedral encodings: encode real unit normals
    from tpu_raytracer.utils import vec3
    enc = vec3.oct_encode(vec3.V3(jnp.asarray(n[..., 0]),
                                  jnp.asarray(n[..., 1]),
                                  jnp.asarray(n[..., 2])))
    octn = np.stack([np.asarray(enc[0]), np.asarray(enc[1])], -1)
    pos = rng.uniform(-1, 1, (h, w, 3)).astype(np.float32)
    return (jnp.asarray(hdr), jnp.asarray(albedo), jnp.asarray(octn),
            jnp.asarray(pos))


@pytest.mark.parametrize("n_bands", [2, 4])
def test_banded_denoise_matches(n_bands):
    h = w = 64   # 4 levels -> max halo 16 = band_h at n_bands=4
    hdr, albedo, octn, pos = _inputs(h, w)
    want = np.asarray(denoise.atrous_denoise(hdr, albedo, octn, pos, 4))
    got = np.asarray(denoise.atrous_denoise_banded(
        hdr, albedo, octn, pos, 4, n_bands))
    np.testing.assert_allclose(want, got, rtol=1e-5, atol=1e-6)
