"""PyTorch port vs the JAX reference: the asset registry, the family
geometry tables and ``place_group`` (placements made from a numpy seed,
positions to 1e-6: the yaw's cos / sin may differ by an ulp between the
libraries)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airgym_tpu import assets as jassets
from airgym_tpu_torch import assets as tassets

FAMILIES = ("thin", "vtrees", "trees", "cubes", "flags", "balls", "objects")


def test_registry_and_semantic_ids_match_jax():
    assert tassets.registry.names() == jassets.registry.names()
    for name in jassets.registry.names():
        assert (dataclasses.asdict(tassets.registry.get_asset(name))
                == dataclasses.asdict(jassets.registry.get_asset(name))), name
    for k in dir(jassets):
        if k.endswith("_SEMANTIC_ID"):
            assert getattr(tassets, k) == getattr(jassets, k), k
    assert tassets.ROBOT_COLLISION_RADIUS == jassets.ROBOT_COLLISION_RADIUS
    # what the tasks read: Avoid's cube, the balls
    cube = tassets.registry.get_asset("cubes/1x1")
    assert cube.geometry == "box" and cube.half_extents == (0.15,) * 3
    assert tassets.registry.get_asset("balls/ball").radius == 0.2


@pytest.mark.parametrize("family", FAMILIES)
def test_family_geometry_matches_jax(family):
    tg, jg = tassets.family_geometry(family), jassets.family_geometry(family)
    for f in tg._fields:
        a, b = getattr(tg, f), getattr(jg, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
            assert a.dtype == b.dtype, f
    assert tassets.num_variants(family) == jassets.num_variants(family)
    if family == "flags":
        assert (tg.annuli[..., 8] >= np.float32(0.01)).all()   # 1 cm rings


def test_unported_families_refuse():
    """Every family of the registry has its table now (vtrees: 13
    cylinders a variant; objects: one box or sphere a variant); a name
    outside the registry still raises."""
    vt, ob = tassets.family_geometry("vtrees"), tassets.family_geometry(
        "objects")
    assert vt.cyls.shape == (100, 13, 9) and (vt.cyls[..., 8] == 1).all()
    assert ob.boxes.shape == (5, 1, 7) and ob.sphs.shape == (5, 1, 5)
    np.testing.assert_array_equal(ob.boxes[:, 0, 6] + ob.sphs[:, 0, 4], 1)
    with pytest.raises(KeyError):
        tassets.family_geometry("no_such_family")


@pytest.mark.parametrize("family", FAMILIES)
def test_place_group_matches_jax(family):
    rng = np.random.default_rng(FAMILIES.index(family))
    n, p = 3, 4
    var = rng.integers(0, jassets.num_variants(family), (n, p))
    pos = rng.uniform(-3, 3, (n, p, 2)).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, (n, p)).astype(np.float32)
    jg = jassets.place_group(family, jnp.asarray(var), jnp.asarray(pos),
                             jnp.asarray(yaw))
    tg = tassets.place_group(family, torch.from_numpy(var),
                             torch.from_numpy(pos), torch.from_numpy(yaw))
    for kind in jg._fields:
        a, b = getattr(tg, kind), getattr(jg, kind)
        assert (a is None) == (b is None), kind
        if a is None:
            continue
        for f in b._fields:
            got, want = getattr(a, f).numpy(), np.asarray(getattr(b, f))
            assert got.shape == want.shape, (kind, f)
            if want.dtype == bool:
                np.testing.assert_array_equal(got, want, err_msg=f"{kind}.{f}")
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                           err_msg=f"{kind}.{f}")
