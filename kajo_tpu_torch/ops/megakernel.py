"""The fused path-tracing pass: a hand-written CUDA kernel and its plain
PyTorch twin.

Port of ``kajo_tpu/ops/pallas/megakernel.py``: ``_build_kernel`` (the Pallas
kernel, forward only) becomes ``csrc/megakernel.cu``, and ``_pack_scene``,
``supports``, ``render_pass_megakernel`` and ``render_passes_megakernel``
keep their roles. The whole regenerating path-trace loop of one lane runs in
one place: stratified camera ray, nearest hit over planes and spheres (rigid
4-float or general 23-float records), Russian roulette, the 4-BSDF lottery,
NEE over all lights or one, the deferred MIS weight, emission and
background. The PCG4D stream (lane, sample, salt, seed) is the JAX kernel's,
so for the same u32 seed the two packages trace the same paths; only ulps of
transcendentals differ.

The wrappers dispatch on the device of the scene's tensors: a CPU scene runs
:func:`render_pass_megakernel_plain`, the same lane loop vectorised over
lanes with masks (as the Pallas body is); a CUDA scene launches the kernel,
or raises. Nothing falls back from CUDA to the plain version.
``kernel_launches`` counts the kernel's launches. The kernel takes a thread
a lane where the lanes fill the card and a thread a (lane, sample) below
one wave of them (:func:`k1_plan`, the same plan as the forward-mode
kernel's), with the same sums, bit for bit, either way.

The plain version divides by 0-d tensors on the scene's device rather than
by Python numbers: PyTorch's CUDA division by a host scalar multiplies by
its reciprocal, which would round differently from the kernel and from the
JAX reference.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from ..models.integrator import RenderConfig
from ..scene.types import Scene, map_tensors
from .geometry import PreparedScene, prepare_scene
from .rng import pass_seed, uniforms4

MAX_KERNEL_OBJECTS = 512
FLT_EPSILON = 1.1920928955078125e-07
BIG = 3.0e38
PI = float(np.float32(np.pi))
CAM_SALT = 0x7FFFFFFF

# packed-buffer record sizes
_PL = 8    # plane: nrow4, det, normal3
_SP = 4    # rigid sphere: cx, cy, cz, r2
_SPG = 23  # general sphere: inv3 row-major (9), invt (3), r2, det, fwd3 row-major (9)
_MA = 14   # material: diffuse3, specular3, emission3, transparency3, exp, ior
_LI = 8    # light: cx, cy, cz, radius, er, eg, eb, obj_id

kernel_launches = 0  # K1
jvp_launches = 0  # K2


def pack_scene(prep: PreparedScene) -> torch.Tensor:
    """Flatten the prepared scene into one f32 vector [F], the layout of the
    JAX ``_pack_scene``: planes (P x 8) | spheres (S x 4 rigid, or S x 23) |
    materials (K x 14) | lights (L x 8) | background (3) | camera (12:
    origin, p1, du, dv)."""
    parts = []
    p = prep.plane_nrow.shape[0]
    if p:
        parts.append(torch.cat([prep.plane_nrow, prep.plane_det[:, None], prep.plane_normal], 1))
    s = prep.sphere_center.shape[0]
    if s and prep.rigid:
        parts.append(torch.cat([prep.sphere_center, prep.sphere_radius2[:, None]], 1))
    elif s:
        parts.append(
            torch.cat(
                [
                    prep.sphere_inv3.reshape(s, 9),
                    prep.sphere_invt,
                    prep.sphere_radius2[:, None],
                    prep.sphere_det[:, None],
                    prep.sphere_fwd3.reshape(s, 9),
                ],
                1,
            )
        )
    m = prep.materials
    parts.append(
        torch.cat(
            [
                m.diffuse[:, :3],
                m.specular[:, :3],
                m.emission[:, :3],
                m.transparency[:, :3],
                m.specular_exponent[:, None],
                m.refractive_index[:, None],
            ],
            1,
        )
    )
    if prep.light_obj.shape[0]:
        parts.append(
            torch.cat(
                [
                    prep.light_center,
                    prep.light_radius[:, None],
                    prep.light_emission[:, :3],
                    prep.light_obj[:, None].to(torch.float32),
                ],
                1,
            )
        )
    cam = prep.camera
    parts += [prep.background[:3], cam.origin, cam.p1, cam.du, cam.dv]
    return torch.cat([x.reshape(-1).to(torch.float32) for x in parts]).contiguous()


def supports(scene: Scene) -> bool:
    """Rigid and general (scaled/sheared) transforms, 1..512 objects."""
    return bool(0 < scene.num_objects <= MAX_KERNEL_OBJECTS)


class MegaParams(ctypes.Structure):
    """Runtime parameters of one pass; mirrors ``MegaParams`` in
    ``csrc/megakernel.cu`` field for field (all 4-byte fields)."""

    _fields_ = [
        ("seed", ctypes.c_uint32),
        ("lane0", ctypes.c_int32),
        ("n_lanes", ctypes.c_int32),
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("grid_n", ctypes.c_int32),
        ("eff", ctypes.c_int32),
        ("n_planes", ctypes.c_int32),
        ("n_spheres", ctypes.c_int32),
        ("n_lights", ctypes.c_int32),
        ("rigid", ctypes.c_int32),
        ("max_depth", ctypes.c_int32),
        ("eps", ctypes.c_float),
        ("emit_after_scatter", ctypes.c_int32),
        ("nee_on", ctypes.c_int32),
        ("one_light", ctypes.c_int32),
        ("ncalls", ctypes.c_int32),
        ("full_mis", ctypes.c_int32),
        ("regen_threshold", ctypes.c_float),
    ]


@dataclasses.dataclass(frozen=True)
class MegaPass:
    """What a pass needs besides its seed; shared by the kernel and the
    plain version."""

    packed: torch.Tensor
    width: int
    height: int
    spp: int
    grid_n: int
    eff: int
    n_planes: int
    n_spheres: int
    n_lights: int
    rigid: bool
    lane0: int
    config: RenderConfig
    lane1: int | None = None  # end of the traced lanes (exclusive); None: W*H

    @property
    def n_lanes(self) -> int:
        end = self.width * self.height if self.lane1 is None else self.lane1
        return end - self.lane0

    @property
    def divisor(self) -> float:
        """kajo divides by spp while taking eff = floor(sqrt(spp))² samples."""
        return float(self.spp if self.config.kajo_spp_quirk else self.eff)

    @property
    def nee_on(self) -> bool:
        return bool(self.config.direct_lighting and self.n_lights > 0)

    @property
    def emit_after_scatter(self) -> bool:
        """Whether emission still counts after a scattering bounce: with NEE
        on, only under full MIS (kajo parity drops it)."""
        return bool((not self.config.direct_lighting) or self.config.full_mis)

    @property
    def one_light(self) -> bool:
        # one-of-L light sampling uses the same uniform budget as all-lights
        # for L > 1, so the PCG4D stream layout is unchanged
        return bool(self.config.one_light_nee and self.n_lights > 1)

    @property
    def ncalls(self) -> int:
        """PCG4D calls per bounce: us[0] RR, us[1] transmit, us[2] diffuse
        vs specular, us[3..4] continuation, then 3 per light (all-lights)
        or us[5] select + us[6..8] sample (one-light)."""
        return -(-max(5 + 3 * self.n_lights, 9 if self.one_light else 0) // 4)

    def params(self, seed: int) -> MegaParams:
        c = self.config
        return MegaParams(
            seed=seed & 0xFFFFFFFF,
            lane0=self.lane0,
            n_lanes=self.n_lanes,
            width=self.width,
            height=self.height,
            grid_n=self.grid_n,
            eff=self.eff,
            n_planes=self.n_planes,
            n_spheres=self.n_spheres,
            n_lights=self.n_lights,
            rigid=int(self.rigid),
            max_depth=c.max_depth,
            eps=c.surface_epsilon,
            emit_after_scatter=int(self.emit_after_scatter),
            nee_on=int(self.nee_on),
            one_light=int(self.one_light),
            ncalls=self.ncalls,
            full_mis=int(c.full_mis),
            regen_threshold=c.regen_threshold,
        )


def prepare_pass(scene: Scene, width, height, spp, config: RenderConfig, lane0=0, lane1=None) -> MegaPass:
    """What a pass of lanes [lane0, lane1) (lane1 None: W*H) needs; an
    empty range is a pass of no lanes."""
    if config.gl_semantics:
        raise ValueError(
            "gl_semantics is implemented by the wavefront (engine fast), not the fused megakernel"
        )
    if not supports(scene):
        raise ValueError(
            f"the megakernel takes 1..{MAX_KERNEL_OBJECTS} objects, got {scene.num_objects}"
        )
    end = width * height if lane1 is None else lane1
    if not 0 <= lane0 <= end <= width * height:
        raise ValueError(f"lanes [{lane0}, {end}) outside the image's {width * height} lanes")
    grid_n = max(int(spp**0.5), 1)
    prep = prepare_scene(scene)
    return MegaPass(
        packed=pack_scene(prep),
        width=width,
        height=height,
        spp=spp,
        grid_n=grid_n,
        eff=grid_n * grid_n,
        n_planes=scene.num_planes,
        n_spheres=scene.num_spheres,
        n_lights=scene.num_lights,
        rigid=prep.rigid,
        lane0=lane0,
        config=config,
        lane1=lane1,
    )


def _image(ps: MegaPass, sums: torch.Tensor) -> torch.Tensor:
    """[3, n_lanes] RGB sums -> [H, W, 4] image divided by ``ps.divisor``,
    alpha 1; the pixels outside [lane0, lane0 + n_lanes) stay 0."""
    img = torch.zeros((ps.width * ps.height, 4), dtype=torch.float32, device=sums.device)
    img[ps.lane0 : ps.lane0 + ps.n_lanes, :3] = sums.T / sums.new_tensor(ps.divisor)
    img[:, 3] = 1.0
    return img.reshape(ps.height, ps.width, 4)


# ------------------------------------------------------------------ CUDA
def call_kernel(source: str, symbol: str, tensors, params: MegaParams) -> None:
    """Call the C entry ``symbol`` of ``csrc/<source>`` with the data
    pointers of ``tensors`` (contiguous float32, on one CUDA device), the
    pass's parameters and the current stream; raises on a CUDA error."""
    from ._nvcc import load_library

    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{symbol} takes contiguous float32 tensors on one CUDA device")
    fn = getattr(load_library(source), symbol)
    fn.argtypes = [ctypes.c_void_p] * (len(tensors) + 2)  # tensors..., params, stream
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), ctypes.addressof(params), stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")


def launch_kernel(ps: MegaPass, seed: int) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream -> [3, n_lanes] sums."""
    global kernel_launches
    out = torch.empty((3, ps.n_lanes), dtype=torch.float32, device=ps.packed.device)
    call_kernel("megakernel.cu", "kajo_megakernel", (ps.packed, out), ps.params(seed))
    kernel_launches += 1
    return out


def uses_kernel(device: torch.device) -> bool:
    """Whether a wrapper launches its CUDA kernel (a CUDA device) or runs
    its plain version (the CPU); raises for any other device."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no megakernel for device {device}")


def lane_sums(ps: MegaPass, seed: int) -> torch.Tensor:
    """The [3, n_lanes] RGB sums of the pass's lanes with u32 pass seed
    ``seed``: one K1 launch on a CUDA scene, its plain version on a CPU one."""
    if ps.n_lanes == 0:  # an empty lane block launches nothing
        return torch.empty((3, 0), dtype=torch.float32, device=ps.packed.device)
    return launch_kernel(ps, seed) if uses_kernel(ps.packed.device) else trace_lanes_plain(ps, seed)


def render_pass_megakernel(
    scene: Scene,
    seed: int,
    width: int,
    height: int,
    spp: int,
    config: RenderConfig = RenderConfig(),
    lane0: int = 0,
) -> torch.Tensor:
    """One progressive pass -> [H, W, 4] on the scene's device.

    ``seed`` is the u32 pass seed. Lanes ``lane0 .. W*H-1`` are traced
    (lane = pixel index, row-major); pixels before ``lane0`` stay 0, so a
    lane-sharded render assembles bit-identically to the whole one."""
    ps = prepare_pass(scene, width, height, spp, config, lane0)
    return _image(ps, lane_sums(ps, seed))


def render_pass_megakernel_plain(
    scene: Scene,
    seed: int,
    width: int,
    height: int,
    spp: int,
    config: RenderConfig = RenderConfig(),
    lane0: int = 0,
) -> torch.Tensor:
    """:func:`render_pass_megakernel` computed by the plain PyTorch version
    on the scene's device (the CUDA kernel's reference)."""
    ps = prepare_pass(scene, width, height, spp, config, lane0)
    return _image(ps, trace_lanes_plain(ps, seed))


def render_passes_megakernel(
    scene: Scene,
    seed: int,
    pass_offset: int,
    width: int,
    height: int,
    spp: int,
    n_passes: int,
    config: RenderConfig = RenderConfig(),
) -> torch.Tensor:
    """Sum of ``n_passes`` passes, accumulated on the scene's device; pass i
    uses the seed ``pass_seed(seed, pass_offset + i)``."""
    ps = prepare_pass(scene, width, height, spp, config)
    total = torch.zeros((height, width, 4), dtype=torch.float32, device=scene.device)
    for i in range(n_passes):
        total += _image(ps, lane_sums(ps, pass_seed(seed, pass_offset + i)))
    return total


# ------------------------------------------------- forward mode (K2)
def scene_zero_tangent(scene: Scene) -> Scene:
    """A tangent of ``scene`` that is 0 everywhere, for
    :func:`render_pass_megakernel_jvp`: set the perturbed entries of its
    tensors (``dataclasses.replace`` with a new tensor, or in place)."""
    return map_tensors(torch.zeros_like, scene)


PLAN_MAX_THREADS = 128  # a CTA of K1's or K2's sample plan (csrc/sample_plan.cuh)
PLAN_SHARED_LIMIT = 232448  # bytes of shared memory a CTA may use on the H100 (227 KB)
JVP_RESIDENT_THREADS = 67584  # 132 SMs x 4 CTAs x 128 threads: below, K2 takes a thread a sample
K1_RESIDENT_THREADS = 84480  # 132 SMs x 5 CTAs x 128 threads (K1's lane kernel): below, a thread a sample
# the shared-byte rules (floats a thread keeps besides its log, floats a lane keeps)
JVP_FLOATS = (7, 6)  # K2: value and tangent sums and a term count; running value and tangent sums
K1_FLOATS = (4, 3)  # K1: value sum and a term count; running sum


def built_plan_constants(source: str) -> tuple:
    """(PLAN_MAX_THREADS, PLAN_SHARED_LIMIT, threshold, *floats) as the
    library of ``csrc/<source>`` (``megakernel.cu``: K1, ``megakernel_jvp.cu``:
    K2) compiled them, for a check of the constants above; builds it, so
    needs nvcc."""
    from ._nvcc import load_library

    out = (ctypes.c_int * 5)()
    getattr(load_library(source), f"kajo_{source.removesuffix('.cu')}_plan_constants")(out)
    return tuple(out)


def sample_terms(max_depth: int) -> int:
    """Radiance terms one sample hands over at most: max_depth + 1
    vertices, each an NEE sum and an emission term, but the last neither
    scatters nor, if it missed, emits."""
    return 2 * max(max_depth, 0) + 1


@dataclasses.dataclass(frozen=True)
class SamplePlan:
    """How K1 or K2 covers the lanes' samples; ``plan`` in
    ``csrc/sample_plan.cuh`` computes the same. A lane's eff samples split
    into ``blocks`` blocks of ``per_block`` consecutive samples (1 or eff),
    one thread each; a CTA of ``threads`` = ``lanes_per_cta`` x ``wave``
    threads walks ``wave`` blocks of each of its lanes at once, ``waves``
    times. The lane's first block sums its terms itself; every later one
    logs up to ``log_terms`` terms. A thread keeps ``thread_floats`` floats
    besides its log, a lane ``lane_floats``."""

    eff: int  # samples a lane
    per_block: int
    blocks: int
    log_terms: int
    lanes_per_cta: int
    wave: int
    waves: int
    thread_floats: int
    lane_floats: int

    @property
    def threads(self) -> int:
        return self.lanes_per_cta * self.wave

    @property
    def shared(self) -> int:
        """Bytes: per thread its log and its other floats, per lane its
        running sums."""
        return 4 * (self.threads * (3 * self.log_terms + self.thread_floats) + self.lane_floats * self.lanes_per_cta)

    def n_ctas(self, n_lanes: int) -> int:
        return -(-n_lanes // self.lanes_per_cta)

    def item(self, cta, wave, thread):
        """(lane index, block) of thread ``thread`` of CTA ``cta`` in wave
        ``wave`` (ints or integer tensors): it walks the block's samples
        block * per_block .. min((block + 1) * per_block, eff) - 1 if the
        lane index is below n_lanes."""
        return cta * self.lanes_per_cta + thread // self.wave, wave * self.wave + thread % self.wave


def sample_plan(n_lanes: int, eff: int, max_depth: int, resident: int, floats: tuple) -> SamplePlan | None:
    """One thread a sample below ``resident`` lanes, else one thread a lane,
    with no log; as many threads a CTA as fit in 128 and its shared memory
    (whole warps where at least one fits), all of a lane's blocks in one
    wave where they fit, else in equal waves of one lane. ``floats``: the
    kernel's shared-byte rule. None where not even one thread's log fits."""
    per_block = 1 if n_lanes < resident else eff
    blocks = eff // per_block
    log_terms = sample_terms(max_depth) if blocks > 1 else 0
    thread_floats, lane_floats = floats
    cap = min(PLAN_SHARED_LIMIT // (4 * (3 * log_terms + thread_floats + lane_floats)), PLAN_MAX_THREADS)
    if cap >= 32:
        cap = cap // 32 * 32
    if cap < 1:
        return None
    if blocks <= cap:
        return SamplePlan(eff, per_block, blocks, log_terms, cap // blocks, blocks, 1, *floats)
    waves = -(-blocks // cap)
    return SamplePlan(eff, per_block, blocks, log_terms, 1, -(-blocks // waves), waves, *floats)


def jvp_plan(n_lanes: int, eff: int, max_depth: int) -> SamplePlan:
    """K2's plan (``jvp_plan`` in ``csrc/megakernel_jvp.cu``): a thread a
    sample below JVP_RESIDENT_THREADS lanes. Raises ValueError where not
    even one thread's log fits."""
    plan = sample_plan(n_lanes, eff, max_depth, JVP_RESIDENT_THREADS, JVP_FLOATS)
    if plan is None:
        raise ValueError(f"the forward-mode kernel's term log takes max_depth <= 9682, got {max_depth}")
    return plan


def k1_plan(n_lanes: int, eff: int, max_depth: int) -> SamplePlan | None:
    """K1's plan (``k1_plan`` in ``csrc/megakernel.cu``): a thread a sample
    below K1_RESIDENT_THREADS lanes; None where K1 takes a thread a lane
    (the lanes fill the card, a lane has one sample, or not even one
    thread's log fits, from max_depth 9684 on)."""
    plan = sample_plan(n_lanes, eff, max_depth, K1_RESIDENT_THREADS, K1_FLOATS)
    return plan if plan is not None and plan.blocks > 1 else None


def launch_kernel_jvp(ps: MegaPass, packed_dot: torch.Tensor, seed: int):
    """Launch the forward-mode kernel K2 -> ([3, n_lanes] sums, their
    tangents)."""
    global jvp_launches
    jvp_plan(ps.n_lanes, ps.eff, ps.config.max_depth)  # raises where the kernel would refuse
    out = torch.empty((2, 3, ps.n_lanes), dtype=torch.float32, device=ps.packed.device)
    call_kernel("megakernel_jvp.cu", "kajo_megakernel_jvp", (ps.packed, packed_dot, out), ps.params(seed))
    jvp_launches += 1
    return out[0], out[1]


def trace_lanes_plain_jvp(ps: MegaPass, packed_dot: torch.Tensor, seed: int):
    """K2's plain version: forward-mode autodiff of :func:`trace_lanes_plain`
    along ``packed_dot`` -> (sums, their tangents)."""
    with fwAD.dual_level():
        sums = trace_lanes_plain(dataclasses.replace(ps, packed=fwAD.make_dual(ps.packed, packed_dot)), seed)
        primal, tangent = fwAD.unpack_dual(sums)
    return primal, (torch.zeros_like(primal) if tangent is None else tangent)


def prepare_pass_jvp(scene: Scene, scene_tangent: Scene, width, height, spp, config: RenderConfig):
    """The pass of ``scene`` and the forward-mode derivative of its packed
    scene along ``scene_tangent`` (``pack_scene(prepare_scene(.))``
    differentiated outside the kernel, as the JAX wrapper does)."""
    with fwAD.dual_level():
        dual = map_tensors(lambda x, t: fwAD.make_dual(x, t.to(x.dtype)), scene, scene_tangent)
        ps = prepare_pass(dual, width, height, spp, config)
        packed, packed_dot = fwAD.unpack_dual(ps.packed)
    packed = packed.detach().contiguous()
    packed_dot = torch.zeros_like(packed) if packed_dot is None else packed_dot.detach().contiguous()
    return dataclasses.replace(ps, packed=packed), packed_dot


def render_pass_megakernel_jvp(
    scene: Scene,
    scene_tangent: Scene,
    seed: int,
    width: int,
    height: int,
    spp: int,
    config: RenderConfig = RenderConfig(),
):
    """Forward mode: (image, d image/dε) of one pass, [H, W, 4] each, where
    ε moves the scene along ``scene_tangent`` (a Scene of tangents, zero but
    for the perturbed entries; see :func:`scene_zero_tangent`).

    Hit distances, normals, sampled directions, pdfs and MIS weights carry
    derivatives; the coin probabilities are detached. A CUDA scene launches
    K2 (``csrc/megakernel_jvp.cu``), whose image equals K1's bit for bit; a
    CPU scene runs :func:`trace_lanes_plain_jvp`. The tangent's alpha is 0."""
    ps, packed_dot = prepare_pass_jvp(scene, scene_tangent, width, height, spp, config)
    if uses_kernel(ps.packed.device):
        sums, sums_dot = launch_kernel_jvp(ps, packed_dot, seed)
    else:
        sums, sums_dot = trace_lanes_plain_jvp(ps, packed_dot, seed)
    img_dot = _image(ps, sums_dot)
    img_dot[..., 3] = 0.0
    return _image(ps, sums), img_dot


# ------------------------------------------------ plain PyTorch version
def _add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def _mul(a, b):
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def _where(m, a, b):
    return tuple(torch.where(m, x, y) for x, y in zip(a, b))


def _normalize(a):
    """Unit vector; 0 for a zero vector."""
    n2 = _dot(a, a)
    nz = n2 > 0
    inv = torch.rsqrt(torch.where(nz, n2, 1.0))
    return tuple(torch.where(nz, x * inv, 0.0) for x in a)


def _reflect(v, n):
    return _sub(v, _scale(n, 2.0 * _dot(n, v)))


def _sqrt_value(x):
    return torch.sqrt(torch.clamp_min(x, 0.0))


def _pow_value(x, n):
    m = x > 0
    return torch.where(
        m, torch.exp(n * torch.log(torch.where(m, x, 1.0))), torch.where(n == 0, 1.0, 0.0)
    )


class SafeSqrt(torch.autograd.Function):
    """sqrt(max(x, 0)) whose derivative is JAX's clamped rule
    (``megakernel.py:safe_sqrt``): 0.5 rsqrt(max(x, 1e-12)) for x > 0, else
    0, so a masked x <= 0 lane gives 0 and not 0 * inf = NaN, in reverse and
    in forward mode."""

    @staticmethod
    def _slope(x):
        return torch.where(x > 0, 0.5 * torch.rsqrt(torch.clamp_min(x, 1e-12)), 0.0)

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        ctx.save_for_forward(x)
        return _sqrt_value(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * SafeSqrt._slope(x)

    @staticmethod
    def jvp(ctx, x_t):
        (x,) = ctx.saved_tensors
        return SafeSqrt._slope(x) * x_t


class SafePow(torch.autograd.Function):
    """x**n as exp(n log x); 0 for x <= 0, except 1 when n == 0. Its
    derivatives are JAX's underflow-safe rule (``megakernel.py:safe_pow``):
    d/dx = n x^(n-1), d/dn = x^n log x where x > 0, else 0."""

    @staticmethod
    def _slopes(x, n):
        m = x > 0
        dx = torch.where(m, n * _pow_value(x, n - 1.0), 0.0)
        dn = torch.where(m, _pow_value(x, n) * torch.log(torch.where(m, x, 1.0)), 0.0)
        return dx, dn

    @staticmethod
    def forward(ctx, x, n):
        ctx.save_for_backward(x, n)
        ctx.save_for_forward(x, n)
        return _pow_value(x, n)

    @staticmethod
    def backward(ctx, g):
        x, n = ctx.saved_tensors
        dx, dn = SafePow._slopes(x, n)
        return _reduce_to(g * dx, x), _reduce_to(g * dn, n)

    @staticmethod
    def jvp(ctx, x_t, n_t):
        x, n = ctx.saved_tensors
        dx, dn = SafePow._slopes(x, n)
        out = 0.0
        if x_t is not None:
            out = out + dx * x_t
        if n_t is not None:
            out = out + dn * n_t
        return out


def _reduce_to(grad, like):
    """Sum a broadcast gradient back to the shape of ``like``."""
    if grad.shape == like.shape:
        return grad
    return grad.sum_to_size(like.shape)


def _safe_sqrt(x):
    return SafeSqrt.apply(x)


def _safe_pow(x, n):
    return SafePow.apply(x, n)


class _ColourFactor(torch.autograd.Function):
    """mat * s whose reverse-mode derivative in ``mat`` is 0 where a colour
    channel is 0: Path Replay (``megakernel_grad.py``) finds a colour's
    gradient through a throughput factor as g * R_rem / colour, which it
    takes as 0 for a colour of 0. Its forward mode is the product rule."""

    @staticmethod
    def forward(ctx, mat, s):
        ctx.save_for_backward(mat, s)
        ctx.save_for_forward(mat, s)
        return mat * s

    @staticmethod
    def backward(ctx, g):
        mat, s = ctx.saved_tensors
        return _reduce_to(torch.where(mat != 0, g * s, 0.0), mat), _reduce_to(g * mat, s)

    @staticmethod
    def jvp(ctx, mat_t, s_t):
        mat, s = ctx.saved_tensors
        out = 0.0
        if mat_t is not None:
            out = out + mat_t * s
        if s_t is not None:
            out = out + mat * s_t
        return out


def _sphere_hit_general(rec, o, d):
    """General-transform sphere hit: object-space stable quadratic with
    determinant-scaled t; the normal is the object-space hit point rotated
    by the forward matrix, normalized. -> (t_world, valid, normal)."""
    ox = rec[0] * o[0] + rec[1] * o[1] + rec[2] * o[2] + rec[9]
    oy = rec[3] * o[0] + rec[4] * o[1] + rec[5] * o[2] + rec[10]
    oz = rec[6] * o[0] + rec[7] * o[1] + rec[8] * o[2] + rec[11]
    dx = rec[0] * d[0] + rec[1] * d[1] + rec[2] * d[2]
    dy = rec[3] * d[0] + rec[4] * d[1] + rec[5] * d[2]
    dz = rec[6] * d[0] + rec[7] * d[1] + rec[8] * d[2]
    r2, det = rec[12], rec[13]
    a = dx * dx + dy * dy + dz * dz
    b = 2.0 * (dx * ox + dy * oy + dz * oz)
    cq = ox * ox + oy * oy + oz * oz - r2
    discr = b * b - 4.0 * a * cq
    sq = _safe_sqrt(discr)
    q = torch.where(b < 0, (-b - sq) * 0.5, (-b + sq) * 0.5)
    t0 = q / torch.where(a == 0, 1.0, a)
    t1 = cq / torch.where(q == 0, 1.0, q)
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    t_loc = torch.where(lo < 0, hi, lo)
    t = t_loc * det
    valid = (discr >= 0) & (hi >= 0) & (a != 0) & (q != 0) & (t >= 0)
    nl = (ox + dx * t_loc, oy + dy * t_loc, oz + dz * t_loc)
    n = _normalize(
        (
            rec[14] * nl[0] + rec[15] * nl[1] + rec[16] * nl[2],
            rec[17] * nl[0] + rec[18] * nl[1] + rec[19] * nl[2],
            rec[20] * nl[0] + rec[21] * nl[1] + rec[22] * nl[2],
        )
    )
    return t, valid, n


def trace_lanes_plain(
    ps: MegaPass,
    seed: int,
    stats: dict | None = None,
    tracked: torch.Tensor | None = None,
    hit_log: list | None = None,
    term_log: list | None = None,
) -> torch.Tensor:
    """The kernel's lane loop, vectorised over lanes -> [3, n_lanes] sums.

    Every state update is masked by ``active``, so the lanes that finished
    their samples keep their sums while the others run on. A ``stats`` dict
    receives the counts of path rays (one per live lane per iteration) and
    shadow rays (one per light, or one, per scattering lane) the pass
    traced, of the path vertices that hit (``hits``) and of those that
    continue by each BSDF (``lambert``, ``phong``, ``mirror``,
    ``transmit``); counting reads them back from the device every
    iteration.

    The walk is differentiable in ``ps.packed`` (reverse and forward mode)
    with the JAX kernels' conventions: the three coin probabilities and the
    shadow ray are detached, and ``safe_sqrt``/``safe_pow`` have clamped
    derivatives; each throughput factor is colour * s through
    :class:`_ColourFactor` (Path Replay's zero gradient for a zero colour).
    The geometry plain version asks for more:
    ``tracked`` (bool [n_lanes, eff, S]) detaches, per lane and sample, the
    records of the spheres it does not track (the geometry kernel's slot
    rule); ``hit_log`` receives (sample, obj, active) of every iteration;
    ``term_log`` receives (sample, mask, term) of every radiance term, in
    the order the sums take them (term [3] of tensors, added where mask)."""
    cfg = ps.config
    s = ps.packed
    dev = s.device
    P, S, L = ps.n_planes, ps.n_spheres, ps.n_lights
    spf = _SP if ps.rigid else _SPG
    off_spheres = P * _PL
    off_mats = off_spheres + S * spf
    off_lights = off_mats + (P + S) * _MA
    off_bg = off_lights + L * _LI
    off_cam = off_bg + 3

    def const(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    pi, two_pi = const(PI), const(2.0 * PI)
    fgrid, fw, fh = const(ps.grid_n), const(ps.width), const(ps.height)
    eps = const(cfg.surface_epsilon)
    eff = ps.eff
    # records as lists of 0-d tensors (scalar broadcast in every op)
    planes = [[s[i * _PL + j] for j in range(_PL)] for i in range(P)]
    spheres = [[s[off_spheres + i * spf + j] for j in range(spf)] for i in range(S)]
    sphere_c2 = [c[0] * c[0] + c[1] * c[1] + c[2] * c[2] - c[3] for c in spheres] if ps.rigid else []
    mat_table = s[off_mats:off_lights].reshape(P + S, _MA)
    light_table = s[off_lights:off_bg].reshape(L, _LI)
    lights = [[light_table[i, j] for j in range(_LI)] for i in range(L)]
    light_ids = light_table[:, 7].to(torch.int64)
    bg = tuple(s[off_bg + j] for j in range(3))
    origin0 = tuple(s[off_cam + j] for j in range(3))
    p1 = tuple(s[off_cam + 3 + j] for j in range(3))
    du = tuple(s[off_cam + 6 + j] for j in range(3))
    dv = tuple(s[off_cam + 9 + j] for j in range(3))

    ncalls = ps.ncalls

    lane = torch.arange(ps.lane0, ps.lane0 + ps.n_lanes, dtype=torch.int64, device=dev)
    seed_t = torch.tensor(seed & 0xFFFFFFFF, dtype=torch.int64, device=dev)
    px = (lane % ps.width).to(torch.float32)
    py = (lane // ps.width).to(torch.float32)
    zf = torch.zeros(lane.shape, dtype=torch.float32, device=dev)
    zi = torch.zeros(lane.shape, dtype=torch.int64, device=dev)

    def camera_ray(sample):
        gx = (sample % ps.grid_n).to(torch.float32)
        gy = (sample // ps.grid_n).to(torch.float32)
        u1, u2, _, _ = uniforms4(lane, sample, CAM_SALT, seed_t)
        sx = (px + (gx + u1) / fgrid) / fw
        sy = ((fh - py) + (gy + u2) / fgrid) / fh
        d = _normalize(_sub(_add(p1, _add(_scale(du, sx), _scale(dv, sy))), origin0))
        return tuple(zf + c for c in origin0), d

    def sphere_rec(i, trk):
        """Sphere i's record; where ``trk`` (bool [n_lanes, S]) is given,
        per lane, detached for the lanes that do not track the sphere."""
        if trk is None:
            return spheres[i]
        return [torch.where(trk[:, i], x, x.detach()) for x in spheres[i]]

    def trace(o, d, trk=None):
        """Nearest hit over planes then spheres -> (t, obj, normal)."""
        t_best = zf + BIG
        obj_best = zi - 1
        n_best = (zf, zf, zf)
        for i, r in enumerate(planes):
            denom = d[0] * r[0] + d[1] * r[1] + d[2] * r[2]
            onum = o[0] * r[0] + o[1] * r[1] + o[2] * r[2] + r[3]
            t_loc = -onum / torch.where(denom == 0, 1.0, denom)
            t = t_loc * r[4]
            valid = (denom.abs() >= FLT_EPSILON) & (t_loc >= 0) & (t >= 0) & (t < t_best)
            t_best = torch.where(valid, t, t_best)
            obj_best = torch.where(valid, i, obj_best)
            n_best = _where(valid, (r[5], r[6], r[7]), n_best)
        if not ps.rigid:
            for i in range(S):
                t, valid, n_new = _sphere_hit_general(sphere_rec(i, trk), o, d)
                valid = valid & (t < t_best)
                t_best = torch.where(valid, t, t_best)
                obj_best = torch.where(valid, P + i, obj_best)
                n_best = _where(valid, n_new, n_best)
            return t_best, obj_best, n_best
        d_dot_o = _dot(d, o)
        o2 = _dot(o, o)
        for i in range(S):
            cx, cy, cz, r2 = sphere_rec(i, trk)
            c2 = sphere_c2[i] if trk is None else cx * cx + cy * cy + cz * cz - r2
            d_dot_c = d[0] * cx + d[1] * cy + d[2] * cz
            o_dot_c = o[0] * cx + o[1] * cy + o[2] * cz
            b = 2.0 * (d_dot_o - d_dot_c)
            cq = o2 - 2.0 * o_dot_c + c2
            discr = b * b - 4.0 * cq
            sq = _safe_sqrt(discr)
            q = torch.where(b < 0, (-b - sq) * 0.5, (-b + sq) * 0.5)
            t1 = cq / torch.where(q == 0, 1.0, q)
            lo = torch.minimum(q, t1)
            hi = torch.maximum(q, t1)
            t = torch.where(lo < 0, hi, lo)
            valid = (discr >= 0) & (hi >= 0) & (q != 0) & (t >= 0) & (t < t_best)
            t_best = torch.where(valid, t, t_best)
            obj_best = torch.where(valid, P + i, obj_best)
            n_best = _where(valid, _normalize(_sub(_add(o, _scale(d, t)), (cx, cy, cz))), n_best)
        return t_best, obj_best, n_best

    def tangent_frame(n):
        """Permutation-trick frame, for planes and spheres alike."""
        smallest = torch.minimum(n[2], torch.minimum(n[0], n[1]))
        mx = n[0] == smallest
        my = n[1] == smallest
        t = _where(mx, (zf, -n[2], n[1]), _where(my, (-n[2], zf, n[0]), (-n[1], n[0], zf)))
        flat = n[1].abs() < 0.9
        up = (torch.where(flat, 0.0, 1.0), torch.where(flat, 1.0, 0.0), zf)
        t = _where(_dot(t, t) < 1e-12, _cross(n, up), t)
        t = _normalize(t)
        return t, _cross(n, t)

    def solid_angle(dist, rad):
        x = torch.clamp(rad / torch.clamp_min(dist, 1e-30), 0.0, 1.0)
        # x²/(1+sqrt(1-x²)) == 1-sqrt(1-x²) without the cancellation that
        # rounds Ω to 0 for far-grazing x
        omega = two_pi * (x * x) / (1.0 + _safe_sqrt(1.0 - x * x))
        return torch.where(dist < rad, 4.0 * PI, omega)

    def light_pdf_from(pos, prev_obj, hit_obj):
        pdf = zf
        for r, obj_id in zip(lights, light_ids):
            delta = _sub((r[0], r[1], r[2]), pos)
            dist = _safe_sqrt(_dot(delta, delta))
            ok = (hit_obj == obj_id) & (prev_obj != obj_id)
            pdf = pdf + torch.where(ok, 1.0 / solid_angle(dist, r[3]), 0.0)
        return pdf

    def add_term(r3, sample, mask, term):
        if term_log is not None:
            term_log.append((sample, mask, term))
        return _where(mask, _add(r3, term), r3)

    sample = zi.clone()
    depth = zi.clone()
    o, d = camera_ray(sample)
    t3 = (zf + 1.0, zf + 1.0, zf + 1.0)
    r3 = (zf, zf, zf)
    emit = torch.ones_like(zi, dtype=torch.bool)
    misp = torch.zeros_like(emit)
    ppdf = zf + 1.0
    pfcos = (zf + 1.0, zf + 1.0, zf + 1.0)
    pdelta = torch.zeros_like(emit)
    prev_obj = zi - 1
    prev_pos = (zf, zf, zf)

    while True:
        active = sample < eff
        if not bool(active.any()):
            break
        salt0 = depth * ncalls
        us = []
        for i in range(ncalls):
            us.extend(uniforms4(lane, sample, (salt0 + i) & 0xFFFFFFFF, seed_t))

        trk = tracked[lane - ps.lane0, torch.clamp_max(sample, eff - 1)] if tracked is not None else None
        t_hit, obj, normal = trace(o, d, trk)
        was_hit = obj >= 0
        if hit_log is not None:
            hit_log.append((sample, obj, active))
        pos_hit = _add(o, _scale(d, torch.where(was_hit, t_hit, 0.0)))

        # deferred MIS weight from the previous vertex
        pdf_l_vis = light_pdf_from(prev_pos, prev_obj, obj) if L else zf
        if cfg.full_mis:
            pdf_l_vis = torch.where(pdelta, 0.0, pdf_l_vis)
        denom = pdf_l_vis + ppdf
        w = 1.0 / torch.where(denom == 0, 1.0, denom)
        t3 = _where(misp & active, _mul(t3, _scale(pfcos, w)), t3)

        # miss -> background; the path ends below since it did not hit
        r3 = add_term(r3, sample, active & ~was_hit, _mul(t3, bg))
        on_path = active & was_hit

        mat = mat_table[obj.clamp_min(0)]
        md = (mat[:, 0], mat[:, 1], mat[:, 2])
        ms = (mat[:, 3], mat[:, 4], mat[:, 5])
        me = (mat[:, 6], mat[:, 7], mat[:, 8])
        mt = (mat[:, 9], mat[:, 10], mat[:, 11])
        mexp = mat[:, 12]
        mior = mat[:, 13]

        # Russian roulette (+ depth limit)
        p_rr = torch.maximum(
            torch.maximum(torch.maximum(md[0], ms[0]), torch.maximum(md[1], ms[1])),
            torch.maximum(
                torch.maximum(md[2], ms[2]),
                torch.maximum(torch.maximum(mt[0], mt[1]), mt[2]),
            ),
        )
        cont = (p_rr > 0) & (us[0] <= p_rr)
        # the coin probabilities are detached, as in the JAX kernels: a
        # discrete outcome carries no derivative, so d(1/prob) would bias it
        prob_rr = torch.where(cont, p_rr, 1.0 - p_rr).detach()
        t3 = _where(on_path, _scale(t3, 1.0 / prob_rr), t3)
        tk = t3
        emitter = on_path & emit
        survive = on_path & cont & (depth < cfg.max_depth)

        # BSDF lottery
        sum_d = md[0] + md[1] + md[2]
        sum_s = ms[0] + ms[1] + ms[2]
        sum_t = mt[0] + mt[1] + mt[2]
        total = sum_d + sum_s + sum_t
        p_t = torch.where(total > 0, sum_t / torch.where(total == 0, 1.0, total), 0.0)
        transmit = (p_t > 0) & (us[1] <= p_t)
        prob_t = torch.where(transmit, p_t, 1.0 - p_t).detach()
        t3 = _where(survive, _scale(t3, 1.0 / prob_t), t3)
        dsum = sum_d + sum_s
        p_d = torch.where(dsum > 0, sum_d / torch.where(dsum == 0, 1.0, dsum), 0.0)
        diffc = (p_d > 0) & (us[2] <= p_d)
        prob_d = torch.where(diffc, p_d, 1.0 - p_d).detach()
        t3 = _where(survive & ~transmit, _scale(t3, 1.0 / prob_d), t3)

        m_trans = survive & transmit
        m_lam = survive & ~transmit & diffc
        m_ph = survive & ~transmit & ~diffc & (mexp > 0)
        m_mir = survive & ~transmit & ~diffc & (mexp <= 0)
        scatter = m_lam | m_ph | m_mir
        if stats is not None:
            stats["rays"] = stats.get("rays", 0) + int(active.sum())
            shadow = int(scatter.sum()) * ((1 if ps.one_light else L) if ps.nee_on else 0)
            stats["shadow_rays"] = stats.get("shadow_rays", 0) + shadow
            for key, m in (("hits", on_path), ("lambert", m_lam), ("phong", m_ph), ("mirror", m_mir),
                           ("transmit", m_trans)):
                stats[key] = stats.get(key, 0) + int(m.sum())

        view = d
        tangent, binormal = tangent_frame(normal)
        refl = _reflect(view, normal)

        if ps.nee_on:

            def nee_light(r, u1, u2, u3, scale):
                """One light's NEE term: solid-angle sample, shadow trace,
                per-light MIS weight scale / (pdf_b + pdf_l)."""
                rad = r[3]
                sx_ = rad * torch.sqrt(u1) * torch.cos(two_pi * u2)
                sy_ = rad * torch.sqrt(u1) * torch.sin(two_pi * u2)
                sz_ = _safe_sqrt(rad * rad - sx_ * sx_ - sy_ * sy_) * torch.sin(pi * (u3 - 0.5))
                c = (r[0], r[1], r[2])
                dl = _normalize(_sub(_add(c, (sx_, sy_, sz_)), pos_hit))
                delta = _sub(c, pos_hit)
                dist = _safe_sqrt(_dot(delta, delta))
                pdf_l = 1.0 / solid_angle(dist, rad)
                # visibility is discrete: the shadow ray is detached
                dl_ = tuple(x.detach() for x in dl)
                _, st_obj, _ = trace(tuple(x.detach() for x in _add(pos_hit, _scale(dl, eps))), dl_)
                obj_id = r[7].to(torch.int64)
                visible = st_obj == obj_id
                not_self = obj != obj_id
                cosl = _dot(normal, dl)
                lobe_l = (mexp + 1.0) / two_pi * _safe_pow(torch.clamp_min(_dot(refl, dl), 0.0), mexp)
                pdf_b_l = torch.where(m_lam, cosl / pi, torch.where(m_ph, lobe_l, 0.0))
                fcos_l = _where(
                    m_lam,
                    _scale(md, torch.clamp_min(cosl, 0.0) / pi),
                    _where(m_ph, _scale(ms, lobe_l * torch.clamp_min(cosl, 0.0)), (zf, zf, zf)),
                )
                ok = visible & not_self & (pdf_b_l != 0) & (pdf_l > 0)
                wl = torch.where(ok, scale / (pdf_b_l + pdf_l), 0.0)
                return _scale(_mul(fcos_l, (r[4], r[5], r[6])), wl)

            if ps.one_light:
                # uniformly pick one light per lane: us[5] selects, us[6..8] sample
                li_v = torch.clamp_max((us[5] * float(L)).to(torch.int64), L - 1)
                rec = light_table[li_v]
                nee = nee_light([rec[:, f] for f in range(_LI)], us[6], us[7], us[8], const(L))
            else:
                nee = (zf, zf, zf)
                one = const(1.0)
                for li, r in enumerate(lights):
                    nee = _add(nee, nee_light(r, us[5 + 3 * li], us[6 + 3 * li], us[7 + 3 * li], one))
            r3 = add_term(r3, sample, scatter, _mul(t3, nee))

        # continuation sample
        u1, u2 = us[3], us[4]
        # transmission
        cos_a = _dot(view, normal)
        entering = cos_a < 0
        n_eff = _where(entering, normal, _scale(normal, -1.0))
        eta = torch.where(entering, 1.0 / mior, mior)
        ci = _dot(view, n_eff)
        kk = 1.0 - eta * eta * (1.0 - ci * ci)
        refr = _sub(_scale(view, eta), _scale(n_eff, eta * ci + _safe_sqrt(kk)))
        d_trans = _where(kk < 0, _reflect(view, n_eff), refr)
        # lambert (cosine hemisphere in the surface frame)
        rl = torch.sqrt(u1)
        phi = u2 * 2.0 * pi
        lz = _safe_sqrt(1.0 - u1)
        d_lam = _add(
            _add(_scale(tangent, rl * torch.cos(phi)), _scale(binormal, rl * torch.sin(phi))),
            _scale(normal, lz),
        )
        pdf_lam = lz / pi
        # phong lobe about the reflection
        uax = _cross((zf, zf, zf + 1.0), refl)
        degen = _dot(uax, uax) < 1e-12
        uax = _normalize(_where(degen, _cross((zf, zf + 1.0, zf), refl), uax))
        vax = _cross(uax, refl)
        cos_ph = _safe_pow(u1, 1.0 / (mexp + 1.0))
        sin_ph = _safe_sqrt(1.0 - cos_ph * cos_ph)
        d_ph = _add(
            _add(_scale(uax, sin_ph * torch.cos(phi)), _scale(vax, sin_ph * torch.sin(phi))),
            _scale(refl, cos_ph),
        )
        pdf_ph = (mexp + 1.0) / two_pi * _safe_pow(cos_ph, mexp)

        new_d = _where(m_trans, d_trans, _where(m_lam, d_lam, _where(m_ph, d_ph, refl)))
        pdf_b = torch.where(m_lam, pdf_lam, torch.where(m_ph, pdf_ph, 1.0))
        cos_nd = _dot(normal, new_d)
        lobe_c = (mexp + 1.0) / two_pi * _safe_pow(torch.clamp_min(_dot(refl, d_ph), 0.0), mexp)
        # f cos = (m_lam ? diffuse : specular) * s_cont, linear in the colour
        s_cont = torch.where(
            m_trans,
            1.0,
            torch.where(
                m_lam,
                torch.clamp_min(cos_nd, 0.0) / pi,
                torch.where(m_ph, lobe_c * torch.clamp_min(cos_nd, 0.0), torch.where(cos_nd > 0, 1.0, 0.0)),
            ),
        )
        fcos = tuple(_ColourFactor.apply(m_, s_cont) for m_ in _where(m_lam, md, ms))

        t3 = _where(m_trans, _mul(t3, fcos), t3)
        r3 = add_term(r3, sample, emitter, _mul(_where(survive, t3, tk), me))
        continuing = survive & (m_trans | (pdf_b != 0))
        if cfg.regen_threshold > 0.0:
            tmax = torch.maximum(torch.maximum(t3[0], t3[1]), t3[2])
            continuing = continuing & (tmax >= cfg.regen_threshold)

        # regeneration
        path_end = active & ~continuing
        new_sample = torch.where(path_end, sample + 1, sample)
        o_cam, d_cam = camera_ray(torch.clamp_max(new_sample, eff - 1))
        o = _where(continuing, _add(pos_hit, _scale(new_d, eps)), _where(path_end, o_cam, o))
        d = _where(continuing, new_d, _where(path_end, d_cam, d))
        t3 = _where(path_end, (zf + 1.0, zf + 1.0, zf + 1.0), t3)
        sc = scatter & ~path_end
        sample = new_sample
        depth = torch.where(path_end, 0, depth + 1)
        emit = path_end | torch.where(scatter, ps.emit_after_scatter, emit)
        misp = sc
        ppdf = torch.where(sc, pdf_b, 1.0)
        pfcos = tuple(torch.where(sc, f, 1.0) for f in fcos)
        pdelta = m_mir & ~path_end
        prev_obj = torch.where(sc, obj, -1)
        prev_pos = tuple(torch.where(sc, p, 0.0) for p in pos_hit)

    return torch.stack(r3)
