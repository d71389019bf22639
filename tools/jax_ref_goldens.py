"""Regenerate the store of the JAX package's outputs (``tests/goldens/jax_ref/``).

    python tools/jax_ref_goldens.py [--prune]

Runs the port's test files (every ``tests/test_torch_*.py`` and
``tests/test_jax_goldens.py``) on 6 workers, as tier-1 does, with
``KAJO_JAX_GOLDENS=write``, so that each JAX computation a test looks up and
does not find in the store is computed and written as ``<key>.npz``
(``tests/jax_goldens.py``). Then prints the keys it wrote, the stored keys
that no test looked up (stale: the inputs, the script or the JAX build
changed; ``--prune`` deletes them) and the store's size. The pytest run's
exit code is the tool's.
"""

import argparse
import glob
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORE = os.path.join(REPO, "tests", "goldens", "jax_ref")


def stored():
    return {os.path.basename(p)[: -len(".npz")] for p in glob.glob(os.path.join(STORE, "*.npz"))}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--prune", action="store_true", help="delete the stored keys no test looked up")
    args = ap.parse_args(argv)
    files = sorted(glob.glob(os.path.join(REPO, "tests", "test_torch_*.py"))) + [
        os.path.join(REPO, "tests", "test_jax_goldens.py")]
    before = stored()
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "keys.log")
        open(log, "w").close()
        env = dict(os.environ, KAJO_JAX_GOLDENS="write", KAJO_JAX_GOLDENS_LOG=log)
        rc = subprocess.call([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "xdist",
                              "-n", "6", "--dist", "loadfile", *files], env=env, cwd=REPO)
        with open(log) as f:
            read = dict(line.split(maxsplit=1) for line in f if line.strip())
    now = stored()
    for key in sorted(now - before):
        print(f"wrote {key} {read.get(key, '').strip()}")
    stale = sorted(now - set(read))
    for key in stale:
        print(f"{'pruned' if args.prune else 'stale'} {key}")
        if args.prune:
            os.remove(os.path.join(STORE, f"{key}.npz"))
    sizes = [os.path.getsize(os.path.join(STORE, f"{k}.npz")) for k in stored()]
    print(f"{len(read)} keys looked up, {len(now - before)} written, {len(stale)} stale; "
          f"store: {len(sizes)} entries, {sum(sizes)} bytes")
    return rc


if __name__ == "__main__":
    sys.exit(main())
