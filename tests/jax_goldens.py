"""The JAX package's outputs that the port's tests compare against, replayed
from ``tests/goldens/jax_ref/`` instead of recomputed on every run.

``kajo_tpu`` is frozen: for the same input bytes, the same script or
function and the same JAX build it returns the same bits. So a computation
of it is stored under the SHA-256 of all of that (:func:`key_of`), and
:func:`cached` returns the stored arrays on a hit. On a miss it computes
them as before and returns them; it writes ``<key>.npz`` only when
``KAJO_JAX_GOLDENS=write`` (``tools/jax_ref_goldens.py`` sets it). With
``KAJO_JAX_GOLDENS_LOG=<file>`` every key looked up is appended to that
file, so the tool can tell which stored entries no test reads.

What goes into a key: ``kind`` (the computation's name), the ``jax``,
``jaxlib`` and ``numpy`` versions, the ``XLA_FLAGS`` the computation runs
under, the host CPU's vector instruction sets unless those flags cap them
(:func:`host_isa`), and ``inputs``: every array's dtype, shape and bytes
(JAX scenes and configs field by field), every other argument, and the
source text of the script or function that computes the outputs
(:func:`source`; for a function, also what each global name it reads is
bound to, :func:`bindings`).
"""

import dataclasses
import functools
import hashlib
import inspect
import os
import platform
import re

import jax
import jaxlib
import numpy as np

STORE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", "jax_ref")
WRITE = "KAJO_JAX_GOLDENS"  # "write": a miss is stored
LOG = "KAJO_JAX_GOLDENS_LOG"  # a file each key looked up is appended to


def _feed(h, x):
    """Hash ``x`` with a tag and a length before every item, so two
    different structures never feed the same bytes."""

    def put(tag, data=b""):
        h.update(tag + len(data).to_bytes(8, "little") + data)

    if x is None:
        put(b"N")
    elif isinstance(x, bool):
        put(b"b", bytes([x]))
    elif isinstance(x, int):
        put(b"i", str(x).encode())
    elif isinstance(x, float):
        put(b"f", x.hex().encode())
    elif isinstance(x, str):
        put(b"s", x.encode())
    elif isinstance(x, bytes):
        put(b"y", x)
    elif isinstance(x, dict):
        put(b"d", str(len(x)).encode())
        for k in sorted(x):
            _feed(h, str(k))
            _feed(h, x[k])
    elif isinstance(x, (list, tuple)):
        put(b"l", str(len(x)).encode())
        for v in x:
            _feed(h, v)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        put(b"c", type(x).__qualname__.encode())
        _feed(h, {f.name: getattr(x, f.name) for f in dataclasses.fields(x)})
    elif hasattr(x, "__array__") or isinstance(x, np.generic):
        a = np.ascontiguousarray(np.asarray(x))
        put(b"a", f"{a.dtype.str}{a.shape}".encode())
        put(b"=", a.tobytes())
    else:
        raise TypeError(f"cannot key an input of type {type(x).__name__}")


def host_isa():
    """The host CPU's architecture and vector instruction sets, which XLA
    compiles for unless ``--xla_cpu_max_isa`` caps them."""
    flags = set()
    if os.path.exists("/proc/cpuinfo"):
        with open("/proc/cpuinfo") as f:
            flags = next((set(line.split(":", 1)[1].split()) for line in f if line.startswith("flags")), set())
    return [platform.machine(), *sorted(f for f in flags if re.match(r"(sse|ssse|avx|fma|f16c|amx)", f))]


def key_of(kind, inputs, xla_flags=None):
    """The store's key of ``kind`` on ``inputs``; ``xla_flags`` are the
    flags of the process that computes it (default: this process's)."""
    flags = os.environ.get("XLA_FLAGS", "") if xla_flags is None else xla_flags
    isa = None if "--xla_cpu_max_isa" in flags else host_isa()
    h = hashlib.sha256()
    _feed(h, dict(kind=kind, jax=jax.__version__, jaxlib=jaxlib.__version__, numpy=np.__version__,
                  xla_flags=flags, isa=isa, inputs=inputs))
    return h.hexdigest()


def path_of(key):
    return os.path.join(STORE, f"{key}.npz")


def lookup(kind, inputs, xla_flags=None):
    """-> (key, the stored arrays or None)."""
    key = key_of(kind, inputs, xla_flags)
    if os.environ.get(LOG):
        with open(os.environ[LOG], "a") as f:
            f.write(f"{key} {kind}\n")
    if not os.path.exists(path_of(key)):
        return key, None
    with np.load(path_of(key)) as f:
        return key, {k: f[k] for k in f.files}


def keep(key, out):
    """``out`` as numpy arrays, stored under ``key`` in write mode."""
    out = {k: np.asarray(v) for k, v in out.items()}
    if os.environ.get(WRITE) == "write":
        os.makedirs(STORE, exist_ok=True)
        tmp = f"{path_of(key)}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **out)
        os.replace(tmp, path_of(key))
    return out


def cached(kind, inputs, compute, xla_flags=None):
    """``compute()`` (a dict of arrays) replayed from the store: the stored
    arrays on a hit, else ``compute()``'s."""
    key, out = lookup(kind, inputs, xla_flags)
    return keep(key, compute()) if out is None else out


def source(*items):
    """The source text of functions, modules or files, for a key."""
    texts = []
    for it in items:
        if isinstance(it, str):
            with open(it) as f:
                texts.append(f.read())
        else:
            texts.append(inspect.getsource(it))
    return texts


def bindings(fn):
    """What each global name ``fn``'s code reads is bound to: a module's
    name, a function's or class's qualified name (with its source where it
    is defined under ``tests/``), a constant's value."""
    names, codes = set(), [fn.__code__]
    while codes:
        code = codes.pop()
        names |= set(code.co_names)
        codes += [c for c in code.co_consts if inspect.iscode(c)]
    out = {}
    for name in sorted(names & fn.__globals__.keys()):
        obj = fn.__globals__[name]
        if inspect.ismodule(obj):
            out[name] = obj.__name__
        elif callable(obj):
            obj = inspect.unwrap(obj)
            out[name] = [f"{obj.__module__}.{obj.__qualname__}"]
            if (inspect.getsourcefile(obj) or "").startswith(os.path.dirname(os.path.abspath(__file__))):
                out[name] += source(obj)
        else:
            out[name] = obj
    return out


def replayed(fn):
    """``fn``, a function of the JAX package's side of a comparison that
    returns a dict of arrays, through :func:`cached`; its key holds every
    argument, ``fn``'s source text and its :func:`bindings`
    (``.inputs(*args)`` gives the kind and inputs of a call). The plain
    function stays at ``.__wrapped__``."""
    signature, kind, text = inspect.signature(fn), f"{fn.__module__}.{fn.__qualname__}", source(fn)

    def inputs(*args, **kwargs):
        bound = signature.bind(*args, **kwargs)
        bound.apply_defaults()
        return kind, dict(bound.arguments, source=text, bindings=bindings(fn))

    @functools.wraps(fn)
    def call(*args, **kwargs):
        return cached(*inputs(*args, **kwargs), lambda: fn(*args, **kwargs))

    call.inputs = inputs
    return call
