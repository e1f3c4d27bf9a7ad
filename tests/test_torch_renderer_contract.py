"""The JAX renderer contract in the port, and actions cast to the action
space's dtype.

A renderer's `render` takes one scene (factors f32[K, 10], num_sprites
i32[], success bool[]) and `render_batch` a batch, as in the JAX package;
`AbstractRenderer.render_batch` defaults to `torch.func.vmap(self.render)`
(JAX: `jax.vmap(self.render)`). A renderer written to that contract gives
the JAX package's values through every entry point; every built-in's
`render` equals its `render_batch` at each lane and JAX's `render`
(anti_aliasing=1 exact, anti_aliasing=2 within +-1 a channel, the bound of
ROADMAP.md). Actions enter a step in the action space's dtype, as a float64
array enters JAX's step as float32 (x64 off). Also here: the last public
symbols (`action_shape_dtype`, `default_factor_rows`, `save_state(force=)`,
the legacy positional restore) against their JAX counterparts.

Inputs are made from numpy seeds and fed to both packages; JAX renders on
the CPU through its XLA rasterizer (no Pallas kernel compiles here).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spriteworld_tpu.core import actions as jactions
from spriteworld_tpu.core import environment as jenvironment
from spriteworld_tpu.core import renderers as jrenderers
from spriteworld_tpu.core import state as jstate_lib
from spriteworld_tpu.core import tasks as jtasks
from spriteworld_tpu.ops import rasterize as jrasterize
from spriteworld_tpu.parallel import checkpoint as jcheckpoint
from spriteworld_tpu.utils import colors as jcolors

from spriteworld_torch.core import actions as tactions
from spriteworld_torch.core import environment as tenvironment
from spriteworld_torch.core import renderers as trenderers
from spriteworld_torch.core import state as tstate
from spriteworld_torch.core import tasks as ttasks
from spriteworld_torch.ops import rasterize as trasterize
from spriteworld_torch.ops import rasterize_cuda as tcuda
from spriteworld_torch.parallel import checkpoint as tcheckpoint
from spriteworld_torch.utils import colors as tcolors
from spriteworld_torch.utils import device as device_lib

import test_torch_env as te


# ---------------------------------------------------------------------- #
# A renderer written to the JAX contract: a masked sum over one factor
# column and the live mask, of one scene.

class _JaxSumX(jrenderers.AbstractRenderer):
    def render(self, factors, num_sprites, success):
        del success
        live = jnp.arange(factors.shape[0]) < num_sprites
        return {"sum_x": jnp.sum(jnp.where(live, factors[:, 0], 0.0)),
                "live": live}

    def observation_spec(self):
        return {"sum_x": jax.ShapeDtypeStruct((), jnp.float32),
                "live": jax.ShapeDtypeStruct((self.max_sprites,), jnp.bool_)}


class _TorchSumX(trenderers.AbstractRenderer):
    def render(self, factors, num_sprites, success):
        del success
        live = torch.arange(factors.shape[0],
                            device=factors.device) < num_sprites
        return {"sum_x": torch.where(live, factors[:, 0], 0.0).sum(),
                "live": live}

    def observation_spec(self):
        return {"sum_x": trenderers.ShapeDtype((), torch.float32),
                "live": trenderers.ShapeDtype((self.max_sprites,),
                                              torch.bool)}


class _TorchSumXBatched(_TorchSumX):
    """Its hand-batched twin."""

    def render_batch(self, factors, num_sprites, success):
        del success
        live = (torch.arange(factors.shape[1], device=factors.device)
                < num_sprites[:, None])
        return {"sum_x": torch.where(live, factors[..., 0], 0.0).sum(-1),
                "live": live}


def _contract_envs(scene, max_episode_length=4, renderers=None):
    """JAX's and the port's environment on `scene`, with the masked sum
    (and its hand-batched twin in the port) or `renderers`, a (JAX, port)
    pair of dicts, beside Success."""

    def make(t, a, r, gen, renderers):
        return dict(
            task=t.FindGoalPosition(goal_position=(0.5, 0.5),
                                    terminate_distance=0.075),
            action_space=a.SelectMove(scale=0.25),
            renderers=dict(renderers, success=r.Success()),
            init_sprites=gen(scene), max_episode_length=max_episode_length)

    if renderers is None:
        renderers = ({"sum_x": _JaxSumX()},
                     {"sum_x": _TorchSumX(), "sum_x_twin": _TorchSumXBatched()})
    jenv = jenvironment.Environment(**make(
        jtasks, jactions, jrenderers, te._JaxFixed, renderers[0]))
    tenv = tenvironment.Environment(**make(
        ttasks, tactions, trenderers, te._TorchFixed, renderers[1]),
        device="cpu")
    return jenv, tenv


def _assert_contract_obs(tobs, jobs, what):
    for name in ("sum_x", "sum_x_twin"):
        for leaf in ("sum_x", "live"):
            np.testing.assert_array_equal(
                tobs[name][leaf].numpy(), np.asarray(jobs["sum_x"][leaf]),
                f"{what}: {name}/{leaf}")
    np.testing.assert_array_equal(tobs["success"].numpy(),
                                  np.asarray(jobs["success"]), what)


def _scenes(rng, b, k):
    """b grid-positioned scenes of k slots, 1..k of them live."""
    f = te._scene_batch(rng, b, k)
    n = rng.integers(1, k + 1, b).astype(np.int32)
    return f, n


def test_jax_contract_renderer_observations_equal_jax():
    """observation_batch (vmap default and the hand-batched twin) and the
    single-lane observation against JAX's, on scenes of different live
    counts; the sums of grid positions are exact in float32."""
    rng = np.random.default_rng(11)
    b, k = 5, 4
    f, n = _scenes(rng, b, k)
    jenv, tenv = _contract_envs(f[0])
    success = rng.uniform(size=b) < 0.5
    jobs = jax.jit(jenv.observation_batch)(jnp.asarray(f), jnp.asarray(n),
                                           jnp.asarray(success))
    tf, tn = torch.from_numpy(f), torch.from_numpy(n)
    tobs = tenv.observation_batch(tf, tn, torch.from_numpy(success))
    assert tobs["sum_x"]["sum_x"].shape == (b,)
    assert tobs["sum_x"]["live"].shape == (b, k)
    _assert_contract_obs(tobs, jobs, "observation_batch")
    # success=None, as the repo's callers pass it to a renderer.
    got = tenv.renderers["sum_x"].render_batch(tf, tn, None)
    np.testing.assert_array_equal(got["sum_x"].numpy(),
                                  np.asarray(jobs["sum_x"]["sum_x"]))
    jone = jax.jit(jenv.observation)
    for i in range(b):
        jo = jone(jnp.asarray(f[i]), jnp.asarray(n[i]),
                  jnp.asarray(success[i]))
        to = tenv.observation(tf[i], tn[i], torch.tensor(success[i]))
        assert to["sum_x"]["sum_x"].shape == ()
        _assert_contract_obs(to, jo, f"observation lane {i}")


def test_jax_contract_renderer_steps_equal_jax():
    """step_batch and BatchedEnvironment.step over episodes with
    auto-resets, on an injected scene and grid actions, against JAX's
    step_batch and BatchedEnvironment.step."""
    rng = np.random.default_rng(12)
    b, k = 4, 3
    scene = te._scene_batch(rng, 1, k)[0]
    jenv, tenv = _contract_envs(scene)
    _, tenv_b = _contract_envs(scene)
    jbenv = jenvironment.BatchedEnvironment(jenv, b)
    tbenv = tenvironment.BatchedEnvironment(tenv_b, b)
    jstep = jax.jit(jenv.step_batch)
    jstate, jts = jax.jit(jenv.reset_batch)(
        jax.random.split(jax.random.key(0), b))
    jbstate, jbts = jbenv.reset(jax.random.key(0))
    tstate_, tts = tenv.reset_batch(b)
    tbstate, tbts = tbenv.reset()
    _assert_contract_obs(tts.observation, jts.observation, "reset_batch")
    _assert_contract_obs(tbts.observation, jbts.observation, "reset")
    firsts = 0
    for t in range(10):
        a = te._grid_actions(rng, b)
        pick = rng.integers(0, k, b)
        hit = rng.uniform(size=b) < 0.7
        a[hit, :2] = np.asarray(jstate.factors)[hit, pick[hit], :2]
        jstate, jts = jstep(jstate, jnp.asarray(a))
        jbstate, jbts = jbenv.step(jbstate, jnp.asarray(a))
        tstate_, tts = tenv.step_batch(tstate_, torch.from_numpy(a))
        tbstate, tbts = tbenv.step(tbstate, a)
        for got, want, what in ((tts, jts, "step_batch"),
                                (tbts, jbts, "BatchedEnvironment.step")):
            np.testing.assert_array_equal(got.step_type.numpy(),
                                          np.asarray(want.step_type))
            _assert_contract_obs(got.observation, want.observation,
                                 f"{what} {t}")
        np.testing.assert_array_equal(tstate_.factors.numpy(),
                                      np.asarray(jstate.factors))
        firsts += int((tts.step_type == tstate.StepType.FIRST).sum())
    assert firsts >= b  # every lane went through an auto-reset


def test_default_render_batch_is_a_vmap_of_render():
    """A one-scene `render` that reads a tensor on the host fails under
    the default render_batch, as under jax.vmap; it is not looped over
    lanes instead."""

    class HostRead(trenderers.AbstractRenderer):
        def render(self, factors, num_sprites, success):
            if num_sprites > 1:
                return factors[0, 0]
            return factors[0, 1]

    f = torch.zeros(3, 2, 10)
    n = torch.tensor([1, 2, 2], dtype=torch.int32)
    with pytest.raises(RuntimeError):
        HostRead().render_batch(f, n, None)
    assert HostRead().render(f[1], n[1], None) == 0.0


# ---------------------------------------------------------------------- #
# Each built-in renderer: render of one scene == render_batch at its lane
# == JAX's render.

def _image_pair(image_size, aa, **kw):
    """JAX's XLA renderer (use_pallas=False) and the port's default."""
    return (jrenderers.ImageRenderer(image_size, anti_aliasing=aa,
                                     color_to_rgb="hsv", use_pallas=False,
                                     **kw),
            trenderers.ImageRenderer(image_size, anti_aliasing=aa,
                                     color_to_rgb="hsv", **kw))


_BUILTINS = {
    "sprite_factors": lambda: (jrenderers.SpriteFactors(),
                               trenderers.SpriteFactors()),
    "sprite_factors_xy": lambda: (
        jrenderers.SpriteFactors(("x", "y", "c0")),
        trenderers.SpriteFactors(("x", "y", "c0"))),
    "passthrough": lambda: (jrenderers.SpritePassthrough(),
                            trenderers.SpritePassthrough()),
    "success": lambda: (jrenderers.Success(), trenderers.Success()),
    "image_aa1": lambda: _image_pair((20, 20), 1),
    "image_aa1_centroid": lambda: _image_pair((20, 20), 1, pil_exact=False),
    "image_aa2": lambda: _image_pair((16, 16), 2),
    "image_aa2_box": lambda: _image_pair((16, 16), 2, pil_exact=False,
                                         bg_color=(10, 20, 30)),
}


def _leaves(tree, prefix=""):
    """{path: leaf} of a nested dict ("" for a bare leaf)."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}/{k}"))
    return out


@pytest.mark.parametrize("name", sorted(_BUILTINS))
def test_builtin_render_is_render_batch_at_a_lane_and_jax(name):
    jr, tr = _BUILTINS[name]()
    k, b = 4, 3
    jr.bind(k), tr.bind(k)
    rng = np.random.default_rng(sorted(_BUILTINS).index(name))
    f = te._scene_batch(rng, b, k, angle0=False)
    n = np.array([4, 1, 2], np.int32)
    s = np.array([True, False, True])
    tf, tn, ts = (torch.from_numpy(x) for x in (f, n, s))
    batch = _leaves(tr.render_batch(tf, tn, ts))
    jone = jax.jit(jr.render)
    image = name.startswith("image")
    tol = 1 if name.startswith("image_aa2") else 0
    for i in range(b):
        got = _leaves(tr.render(tf[i], tn[i], ts[i]))
        want = _leaves(jone(jnp.asarray(f[i]), jnp.asarray(n[i]),
                            jnp.asarray(s[i])))
        assert set(got) == set(want) == set(batch), name
        for leaf, g in got.items():
            assert g.shape == batch[leaf].shape[1:], (name, leaf)
            torch.testing.assert_close(g, batch[leaf][i], rtol=0, atol=0,
                                       msg=f"{name}/{leaf} lane {i}")
            w = np.asarray(want[leaf])
            assert g.shape == w.shape, (name, leaf)
            assert device_lib.numpy_dtype(g.dtype) == w.dtype, (name, leaf)
            diff = np.abs(g.numpy().astype(np.float64) - w.astype(np.float64))
            assert diff.max() <= tol, (name, leaf, i, diff.max())
        if image:
            assert got[""].numpy().any(), (name, i)


@pytest.mark.parametrize("aa", [1, 2])
def test_image_renderer_renders_through_rasterize_cuda_only(aa):
    """ImageRenderer renders through ops/rasterize_cuda.py (on the CPU its
    plain version, equal to ops/rasterize.py's), one scene and a batch,
    with no kernel counted; JAX's `use_pallas`, which would pick another
    rasterizer, is refused."""
    rng = np.random.default_rng(30 + aa)
    f = torch.from_numpy(te._scene_batch(rng, 3, 4, angle0=False))
    n = torch.tensor([4, 2, 3], dtype=torch.int32)
    r = trenderers.ImageRenderer((16, 16), anti_aliasing=aa,
                                 color_to_rgb="hsv")
    kw = dict(image_size=(16, 16), anti_aliasing=aa,
              color_to_rgb=tcolors.hsv_to_rgb)
    tcuda.reset_launch_counts()
    want = trasterize.render_rgb_batch(f, n, **kw)
    torch.testing.assert_close(r.render_batch(f, n, None), want,
                               rtol=0, atol=0)
    torch.testing.assert_close(tcuda.render_rgb_batch(f, n, **kw), want,
                               rtol=0, atol=0)
    for i in range(3):
        torch.testing.assert_close(r.render(f[i], n[i], None), want[i],
                                   rtol=0, atol=0)
        torch.testing.assert_close(tcuda.render_rgb(f[i], n[i], **kw),
                                   want[i], rtol=0, atol=0)
    assert all(w.launches == 0 for w in (
        tcuda.scene_raster, tcuda.strip_raster, tcuda.strip_vpass,
        tcuda.packed_raster))
    for use_pallas in ("auto", True, False):
        with pytest.raises(TypeError, match="use_pallas"):
            trenderers.ImageRenderer(use_pallas=use_pallas)


def _subclass(base, boolean, cast):
    """A subclass of `base` whose `render` changes each leaf of its
    parent's by the scene's live count, which only a one-scene call
    broadcasts right: a leaf of dtype `boolean` xor-ed with
    `num_sprites > 1`, any other plus `num_sprites` (`cast` to its dtype;
    uint8 wraps alike in both packages)."""

    def bump(x, n):
        return x ^ (n > 1) if x.dtype == boolean else x + cast(n, x.dtype)

    class Sub(base):
        def render(self, factors, num_sprites, success):
            out = super().render(factors, num_sprites, success)
            if isinstance(out, dict):
                return {k: bump(v, num_sprites) for k, v in out.items()}
            return bump(out, num_sprites)

    return Sub


_SUBCLASSED = ["SpriteFactors", "SpritePassthrough", "Success",
               "ImageRenderer"]


@pytest.mark.parametrize("name", _SUBCLASSED)
def test_subclass_render_override_reaches_render_batch_as_in_jax(name):
    """A built-in's subclass that overrides `render` gives JAX's batched
    observation through `observation_batch`: SpriteFactors,
    SpritePassthrough and Success batch the subclass's `render` (JAX's
    render_batch is jax.vmap(self.render)), ImageRenderer keeps its own
    batched body (as JAX's does)."""
    args = ((16, 16),) if name == "ImageRenderer" else ()
    kw = {"color_to_rgb": "hsv"} if name == "ImageRenderer" else {}
    jr = _subclass(getattr(jrenderers, name), jnp.bool_,
                   lambda n, d: n.astype(d))(*args, **kw)
    tr = _subclass(getattr(trenderers, name), torch.bool,
                   lambda n, d: n.to(d))(*args, **kw)
    k, b = 4, 3
    rng = np.random.default_rng(40 + _SUBCLASSED.index(name))
    f = te._scene_batch(rng, b, k, angle0=False)
    n = np.array([4, 1, 2], np.int32)
    s = np.array([True, False, True])
    jenv, tenv = _contract_envs(f[0], renderers=({"sub": jr}, {"sub": tr}))
    tf, tn, ts = (torch.from_numpy(x) for x in (f, n, s))
    got = _leaves(tenv.observation_batch(tf, tn, ts)["sub"])
    want = _leaves(jax.jit(jenv.observation_batch)(
        jnp.asarray(f), jnp.asarray(n), jnp.asarray(s))["sub"])
    assert set(got) == set(want), name
    for leaf, g in got.items():
        np.testing.assert_array_equal(g.numpy(), np.asarray(want[leaf]),
                                      f"{name}{leaf}")
        if name != "ImageRenderer":
            for i in range(b):
                one = _leaves(tr.render(tf[i], tn[i], ts[i]))[leaf]
                torch.testing.assert_close(g[i], one, rtol=0, atol=0)
    # The built-in itself still batches with its own body.
    base = getattr(trenderers, name)(*args, **kw).bind(k)
    assert _leaves(base.render_batch(tf, tn, ts)).keys() == got.keys()


def test_observation_spec_has_jax_shape_and_dtype():
    for name in sorted(_BUILTINS) + ["user"]:
        jr, tr = ((_JaxSumX(), _TorchSumX()) if name == "user"
                  else _BUILTINS[name]())
        jr.bind(5), tr.bind(5)
        jspec, tspec = _leaves(jr.observation_spec()), _leaves(
            tr.observation_spec())
        assert set(jspec) == set(tspec), name
        for leaf, t in tspec.items():
            assert isinstance(t, trenderers.ShapeDtype), (name, leaf)
            shape, dtype = t  # unpacks as the port's callers unpack it
            assert t[0] == shape == tuple(jspec[leaf].shape), (name, leaf)
            assert device_lib.numpy_dtype(dtype) == jspec[leaf].dtype, (
                name, leaf)


# ---------------------------------------------------------------------- #
# ops: render_rgb renders one scene, render_rgb_batch a batch.

@functools.lru_cache(maxsize=None)
def _jax_render_rgb(**kwargs):
    kwargs = dict(kwargs)
    if kwargs.pop("hsv", False):
        kwargs["color_to_rgb"] = jcolors.hsv_to_rgb
    return jax.jit(lambda f, n: jrasterize.render_rgb(f, n, **kwargs))


@pytest.mark.parametrize("kw", [
    dict(image_size=(20, 20), anti_aliasing=1, hsv=True),
    dict(image_size=(16, 16), anti_aliasing=2, hsv=True),
    dict(image_size=(16, 24), anti_aliasing=2, pil_exact=False),
], ids=["aa1", "aa2", "aa2_centroid"])
def test_render_rgb_is_one_scene_of_render_rgb_batch_and_jax(kw):
    rng = np.random.default_rng(kw["anti_aliasing"] + kw["image_size"][1])
    b, k = 3, 5
    f = te._scene_batch(rng, b, k, angle0=False)
    n = np.array([5, 2, 4], np.int32)
    tkw = dict(kw)
    if tkw.pop("hsv", False):
        tkw["color_to_rgb"] = tcolors.hsv_to_rgb
    tf, tn = torch.from_numpy(f), torch.from_numpy(n)
    batch = trasterize.render_rgb_batch(tf, tn, **tkw)
    kernels = tcuda.render_rgb_batch(tf, tn, **tkw)
    tol = 0 if kw["anti_aliasing"] == 1 else 1
    h, w = kw["image_size"]
    for i in range(b):
        one = trasterize.render_rgb(tf[i], tn[i], **tkw)
        assert one.shape == (h, w, 3) and one.dtype == torch.uint8
        torch.testing.assert_close(one, batch[i], rtol=0, atol=0)
        # A Python int count, as JAX's render_rgb takes one.
        torch.testing.assert_close(
            trasterize.render_rgb(tf[i], int(n[i]), **tkw), one,
            rtol=0, atol=0)
        torch.testing.assert_close(tcuda.render_rgb(tf[i], tn[i], **tkw),
                                   kernels[i], rtol=0, atol=0)
        want = np.asarray(_jax_render_rgb(**kw)(jnp.asarray(f[i]),
                                                jnp.asarray(n[i])))
        diff = np.abs(one.numpy().astype(int) - want.astype(int))
        assert diff.max() <= tol, (i, diff.max())


# ---------------------------------------------------------------------- #
# Actions take the action space's dtype.

_PROBE_STEPS = 400


def test_float64_actions_step_as_jax_float32():
    """ROADMAP's float64 probe: 400 single-lane steps of float64 actions
    clicking on a sprite's centre, through Environment.step and
    BatchedEnvironment.step, against JAX's jitted step: no step off its
    state; rewards float32 and equal to those of the same actions in
    float32; a float32 action after the float64 ones steps."""
    import test_torch_compiled_step as tc

    rng = np.random.default_rng(7)
    scene = te._scene_batch(np.random.default_rng(7), 1, 3)[0]
    jenv, tenv = tc._pair(scene, 1, max_episode_length=20)
    _, tenv_b = tc._pair(scene, 1, max_episode_length=20)
    _, tenv_32 = tc._pair(scene, 1, max_episode_length=20)
    jstep = jax.jit(jenv.step)
    jstate, _ = jax.jit(jenv.reset)(jax.random.key(0))
    tstate_, _ = tenv.reset()
    state32, _ = tenv_32.reset()
    benv = tenvironment.BatchedEnvironment(tenv_b, 1)
    bstate, _ = benv.reset()
    off_env = off_batched = 0
    for t in range(_PROBE_STEPS):
        a = rng.uniform(0, 1, 4)
        a[:2] = np.asarray(jstate.factors)[rng.integers(0, 3), :2]
        assert a.dtype == np.float64
        jstate, jts = jstep(jstate, jnp.asarray(a))
        tstate_, tts = tenv.step(tstate_, a)
        bstate, bts = benv.step(bstate, a[None])
        state32, ts32 = tenv_32.step(state32, torch.from_numpy(
            a.astype(np.float32)))
        want = np.asarray(jstate.factors)
        off_env += not np.array_equal(tstate_.factors.numpy(), want)
        off_batched += not np.array_equal(bstate.factors[0].numpy(), want)
        for ts in (tts, bts):
            assert ts.reward.dtype == torch.float32
        assert tts.reward.numpy().tobytes() == ts32.reward.numpy().tobytes()
        assert bts.reward[0].numpy().tobytes() == ts32.reward.numpy(
            ).tobytes()
        np.testing.assert_array_equal(tts.step_type.numpy(),
                                      np.asarray(jts.step_type))
    assert (off_env, off_batched) == (0, 0)
    bstate, bts = benv.step(bstate, a.astype(np.float32)[None])
    assert bts.reward.dtype == torch.float32
    assert benv._compiled._actions.dtype == torch.float32


def _embodied_pair(scene):
    def make(t, a, r, gen):
        return dict(task=t.FindGoalPosition(goal_position=(0.5, 0.5)),
                    action_space=a.Embodied(step_size=0.0625),
                    renderers={"factors": r.SpriteFactors()},
                    init_sprites=gen(scene), max_episode_length=6)

    return (jenvironment.Environment(**make(jtasks, jactions, jrenderers,
                                            te._JaxFixed)),
            tenvironment.Environment(**make(ttasks, tactions, trenderers,
                                            te._TorchFixed), device="cpu"))


def test_int64_embodied_actions_step_as_int32():
    rng = np.random.default_rng(3)
    scene = te._scene_batch(rng, 1, 3)[0]
    jenv, tenv = _embodied_pair(scene)
    _, tenv_b = _embodied_pair(scene)
    jstep = jax.jit(jenv.step)
    jstate, _ = jax.jit(jenv.reset)(jax.random.key(0))
    tstate_, _ = tenv.reset()
    benv = tenvironment.BatchedEnvironment(tenv_b, 1)
    bstate, _ = benv.reset()
    for t in range(20):
        a = np.array([rng.integers(0, 2), rng.integers(0, 4)], np.int64)
        jstate, jts = jstep(jstate, jnp.asarray(a))
        tstate_, tts = tenv.step(tstate_, a)
        bstate, bts = benv.step(bstate, a[None])
        np.testing.assert_array_equal(tstate_.factors.numpy(),
                                      np.asarray(jstate.factors), f"{t}")
        np.testing.assert_array_equal(bstate.factors[0].numpy(),
                                      np.asarray(jstate.factors), f"{t}")
        np.testing.assert_array_equal(tts.reward.numpy(),
                                      np.asarray(jts.reward), f"{t}")
    assert benv._compiled._actions.dtype == torch.int32
    # step_batch casts a tensor of another dtype, as JAX's step takes it.
    state, _ = tenv.reset_batch(2)
    actions = torch.tensor([[1, 2], [0, 3]], dtype=torch.int32)
    want, _ = tenv.step_batch(state.clone(), actions)
    got, _ = tenv.step_batch(state.clone(), actions.to(torch.int64))
    torch.testing.assert_close(got.factors, want.factors, rtol=0, atol=0)


class _NoShapeDtype:
    """An action space written for the JAX package, whose Environment never
    reads `action_shape_dtype`: it has `step`, `action_spec` and `sample`
    only."""

    def __init__(self, space):
        self._space = space

    def step(self, *args):
        return self._space.step(*args)

    def action_spec(self):
        return self._space.action_spec()

    def sample(self, *args):
        return self._space.sample(*args)


@pytest.mark.parametrize("space", ["SelectMove", "Embodied"])
def test_action_space_without_shape_dtype_takes_jax_x64_off_rule(space):
    """64-bit numpy actions into an action space with no
    `action_shape_dtype` step as JAX with x64 off takes them (float64 as
    float32, int64 as int32): through Environment.step and
    BatchedEnvironment.step, the states and rewards of the built-in space,
    which has the property."""
    rng = np.random.default_rng(21)
    scene = te._scene_batch(rng, 1, 3)[0]
    want_dtype = getattr(tactions, space)().action_shape_dtype[1]

    def env(wrap):
        a = getattr(tactions, space)()
        return tenvironment.Environment(
            task=ttasks.FindGoalPosition(goal_position=(0.5, 0.5)),
            action_space=_NoShapeDtype(a) if wrap else a,
            renderers={"factors": trenderers.SpriteFactors()},
            init_sprites=te._TorchFixed(scene), max_episode_length=6,
            device="cpu")

    envs = [env(False), env(True)]
    states = [e.reset()[0] for e in envs]
    benvs = [tenvironment.BatchedEnvironment(env(w), 2) for w in (0, 1)]
    bstates = [b.reset()[0] for b in benvs]
    for t in range(12):
        if space == "Embodied":
            a = rng.integers(0, [2, 4], (2, 2)).astype(np.int64)
        else:
            a = rng.uniform(0, 1, (2, 4))
            a[:, :2] = scene[rng.integers(0, 3, 2), :2]
        out = [e.step(s, a[0]) for e, s in zip(envs, states)]
        states = [o[0] for o in out]
        bout = [b.step(s, a) for b, s in zip(benvs, bstates)]
        bstates = [o[0] for o in bout]
        for x, y in (out, bout):
            np.testing.assert_array_equal(x[0].factors.numpy(),
                                          y[0].factors.numpy(), f"{t}")
            assert x[1].reward.numpy().tobytes() == y[1].reward.numpy(
                ).tobytes()
            assert y[1].reward.dtype == torch.float32
    assert [b._compiled._actions.dtype for b in benvs] == [want_dtype] * 2


# ---------------------------------------------------------------------- #
# The last public symbols against the JAX package's.

@pytest.mark.parametrize("space", ["SelectMove", "DragAndDrop", "Embodied"])
def test_action_shape_dtype_equals_jax(space):
    jshape, jdtype = getattr(jactions, space)().action_shape_dtype
    tshape, tdtype = getattr(tactions, space)().action_shape_dtype
    assert tuple(tshape) == tuple(jshape)
    assert device_lib.numpy_dtype(tdtype) == np.dtype(jdtype)
    assert isinstance(tdtype, torch.dtype)


@pytest.mark.parametrize("rows", [0, 1, 7])
def test_default_factor_rows_equals_jax(rows):
    got = tstate.default_factor_rows(rows, device="cpu")
    want = np.asarray(jstate_lib.default_factor_rows(rows))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    got[:, 0] = 0.25  # a fresh tensor, not a view of a shared row
    assert tstate.default_factor_rows(1, device="cpu")[0, 0] == 0.5


def _tree(rng):
    return {"b": rng.integers(0, 9, (3,)).astype(np.int32),
            "a": rng.standard_normal((2, 3)).astype(np.float32),
            "c": [rng.uniform(size=(4,)).astype(np.float32),
                  np.array(rng.uniform() < 0.5)]}


def _like():
    return {"b": torch.zeros(3, dtype=torch.int32), "a": torch.zeros(2, 3),
            "c": [torch.zeros(4), torch.zeros((), dtype=torch.bool)]}


def test_save_state_force(tmp_path):
    """force=True (the default) overwrites; force=False refuses an existing
    checkpoint (FileExistsError, as orbax refuses) and writes a new one."""
    rng = np.random.default_rng(0)
    first, second = _tree(rng), _tree(rng)
    path = str(tmp_path / "ck")
    tcheckpoint.save_state(path, _torch_tree(first), force=False)
    with pytest.raises(FileExistsError):
        tcheckpoint.save_state(path, _torch_tree(second), force=False)
    _assert_tree_np(tcheckpoint.restore_state(path, _like()), first)
    tcheckpoint.save_state(path, _torch_tree(second))
    _assert_tree_np(tcheckpoint.restore_state(path, _like()), second)
    tcheckpoint.save_state(path, _torch_tree(first), force=True)
    _assert_tree_np(tcheckpoint.restore_state(path, _like()), first)


def _torch_tree(tree):
    return {"b": torch.from_numpy(tree["b"]), "a": torch.from_numpy(
        tree["a"]), "c": [torch.from_numpy(x) for x in tree["c"]]}


def _assert_tree_np(got, want):
    for key in ("a", "b"):
        np.testing.assert_array_equal(got[key].numpy(), want[key])
    for g, w in zip(got["c"], want["c"]):
        np.testing.assert_array_equal(g.numpy(), w)


def test_legacy_positional_restore_equals_jax(tmp_path, monkeypatch):
    """A positional `arr_<i>` .npz restores in `like`'s leaf order where
    the counts match and raises ValueError where they do not: the port
    against the JAX package's npz branch (taken with orbax switched off)
    on one file."""
    monkeypatch.setattr(jcheckpoint, "_HAS_ORBAX", False)
    rng = np.random.default_rng(1)
    tree = _tree(rng)
    leaves = jax.tree.leaves(tree)
    path = str(tmp_path / "legacy")
    np.savez(path + ".npz", *leaves)
    jlike = jax.tree.map(np.zeros_like, tree)
    want = jcheckpoint.restore_state(path, jlike)
    got = tcheckpoint.restore_state(path, _like())
    _assert_tree_np(got, jax.tree.map(np.asarray, want))
    _assert_tree_np(got, tree)
    assert got["b"].dtype == torch.int32 and got["c"][1].dtype == torch.bool

    short = str(tmp_path / "short")
    np.savez(short + ".npz", *leaves[:-1])
    with pytest.raises(ValueError, match="leaves"):
        jcheckpoint.restore_state(short, jlike)
    with pytest.raises(ValueError, match="leaves"):
        tcheckpoint.restore_state(short, _like())


def test_chip_smoke_phase_11_runs_on_the_cpu(monkeypatch):
    """chip_smoke.py's phase 11 (renderer contract, action dtypes) at small
    canvases on the CPU: its control flow and its checks of (a)-(d), with
    no kernel counted and no graph (both need the card)."""
    import bench_torch
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "CONTRACT_CASES", [
        (label, (16, 16), min(aa, 3), want)
        for label, _, aa, want in chip_smoke.CONTRACT_CASES])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda *args: None)
    launched, worst = chip_smoke.renderer_contract(
        torch, bench_torch, tcuda, "the CPU", dev="cpu")
    assert launched == {} and worst == 0
