"""The JAX package's initial draw (init_params at a seed), carried to a
machine without JAX in a few MB instead of the draw's 500 MB.

The draw is threefry2x32 bits turned into normal or truncated-normal
numbers; this module recomputes both in numpy (the bits exactly, the
erf_inv as XLA's f32 polynomial), so the packed file holds, per kernel,
its PRNG key and scale and only the elements where the recomputation
misses JAX's value (about 1%), with those values; every other leaf
(biases, norms' ones) is stored as it is.  Unpacking checks each leaf's
SHA-256 against JAX's.

    JAX_PLATFORMS=cpu python studies/jax_draw.py pack --ngf 64 --seed 0 \
        --out build/jax_draw_ngf64_s0.npz
    python studies/jax_draw.py unpack build/jax_draw_ngf64_s0.npz DIR

`unpack` (numpy only) writes DIR/s<seed>/{G,P,D,F,vgg}.npz, flat dicts
as the JAX package's export_network_npz writes them, which
studies/protocol_spread.py --init_from reads; protocol_spread.py also
takes the packed file itself, and `load` gives the checked draw in
memory (chip_smoke.py phase 15 reads the committed
artifacts/jax_cpu_f32/jax_draw_ngf64_s0.npz so).
"""

from __future__ import annotations

import argparse
import hashlib
import json
from pathlib import Path

import numpy as np

NETS = ("G", "P", "D", "F", "vgg")
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
# XLA's f32 erf_inv: w = -log1p(-x*x); a degree-8 polynomial in w - 2.5
# (w < 5) or sqrt(w) - 3, times x
_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
        0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
        1.50140941)
_GT5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
        0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
        2.83297682)
_F = np.float32
_SQRT2 = _F(np.sqrt(2))


def _threefry2x32(key, x0, x1):
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0, x1 = x0 + ks[0], x1 + ks[1]
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 = x0 ^ x1
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def random_bits(key, n: int) -> np.ndarray:
    """jax.random.bits(key, (n,), uint32) under jax_threefry_partitionable
    (the flat index as a 64-bit counter)."""
    idx = np.arange(n, dtype=np.uint64)
    b0, b1 = _threefry2x32(key, (idx >> np.uint64(32)).astype(np.uint32),
                           (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return b0 ^ b1


def _uniform(key, n: int, lo, hi) -> np.ndarray:
    """jax.random.uniform, its `floats * (hi - lo) + lo` fused as XLA's
    CPU backend fuses it (in f64, rounded once)."""
    lo, hi = _F(lo), _F(hi)
    bits = (random_bits(key, n) >> np.uint32(9)) | np.uint32(0x3F800000)
    f = (bits.view(_F) - _F(1)).astype(np.float64)
    return np.maximum(lo, (f * np.float64(hi - lo) + lo).astype(_F))


def _erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's f32 erf_inv, its log1p taken in f64 and each Horner step as a
    fused multiply-add (both rounded once to f32); within 3 ulps of XLA's
    CPU result, equal in ~99% of elements."""
    w = -np.log1p((-(x * x)).astype(np.float64)).astype(_F)
    lt = w < _F(5)
    w = np.where(lt, w - _F(2.5), np.sqrt(w) - _F(3)).astype(np.float64)
    p = np.where(lt, _F(_LT5[0]), _F(_GT5[0]))
    for lo, hi in zip(_LT5[1:], _GT5[1:]):
        c = np.where(lt, _F(lo), _F(hi)).astype(np.float64)
        p = (c + p.astype(np.float64) * w).astype(_F)
    return np.where(np.abs(x) == _F(1), x * np.finfo(_F).max, p * x)


def draw(kind: str, key, n: int, a=None, b=None) -> np.ndarray:
    """What jax.random.normal(key, (n,)) / sqrt 2 (XLA folds the sqrt 2
    into the initializer's scale) or truncated_normal(key, -2, 2, (n,))
    computes, with a, b = erf(-+2 / sqrt 2) as JAX's f32 erf gives them."""
    if kind == "normal":
        return _erf_inv(_uniform(key, n, np.nextafter(_F(-1), _F(0)), 1.0))
    u = _uniform(key, n, a, b)
    return np.clip(_SQRT2 * _erf_inv(u), np.nextafter(_F(-2), _F(3)),
                   np.nextafter(_F(2), _F(-3)))


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def pack(out: Path, ngf: int, seed: int, size: int = 128) -> dict:
    """JAX's init_params of the protocol at `ngf` and `seed` (the draw
    studies/jax_cpu_protocol.py --run init exports), packed; `size` is
    the protocol's 128 px (its depth follows the size)."""
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_platforms", "cpu")
    from deepinpainting_tpu.config import Config
    from deepinpainting_tpu.engine.inpaint import init_params
    from jax._src.nn import initializers as I

    cfg = Config(fine_size=size, batch_size=8, ngf=ngf, ndf=ngf,
                 vgg_width_scale=ngf / 64, attention_impl="lax", seed=seed)
    params = init_params(cfg, jax.random.PRNGKey(seed))
    # the keys of every random draw of the init, from a second jitted
    # init whose draws report them (the draw above is the one packed)
    calls = []
    normal, trunc = jax.random.normal, jax.random.truncated_normal

    def record(kind, key, shape, extra=()):
        jax.debug.callback(
            lambda k: calls.append((kind, np.asarray(k), tuple(shape),
                                    extra)), jax.random.key_data(key))

    def normal_hook(key, shape=(), dtype=jnp.float32, **kw):
        record("normal", key, shape)
        return normal(key, shape, dtype, **kw)

    def trunc_hook(key, lower, upper, shape=None, dtype=jnp.float32, **kw):
        record("trunc", key, shape, (float(lower), float(upper)))
        return trunc(key, lower, upper, shape, dtype, **kw)
    jax.random.normal, I.random.normal = normal_hook, normal_hook
    jax.random.truncated_normal = I.random.truncated_normal = trunc_hook
    try:
        jax.block_until_ready(init_params(cfg, jax.random.PRNGKey(seed)))
    finally:
        jax.random.normal = I.random.normal = normal
        jax.random.truncated_normal = I.random.truncated_normal = trunc
    ab = {}
    for kind, _, _, (lower, upper) in (c for c in calls if c[0] == "trunc"):
        ab[(lower, upper)] = [float(jax.lax.erf(_F(v) / _SQRT2))
                              for v in (lower, upper)]

    arrays, meta, free = {}, {"ngf": ngf, "seed": seed, "leaves": {}}, calls
    for net in NETS:
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                params[net])[0]:
            name = net + ":" + "/".join(
                str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            L = np.asarray(leaf)
            entry = {"shape": list(L.shape), "sha256": _sha(L)}
            for c in free:
                kind, key, shape, extra = c
                if shape != L.shape or L.size < 64:
                    continue
                a, b = ab.get(extra, (None, None))
                O = draw(kind, key, L.size, a, b).reshape(L.shape)
                fit = _F(np.dot(L.ravel().astype(np.float64), O.ravel())
                         / np.dot(O.ravel().astype(np.float64), O.ravel()))
                scale = min((fit + np.spacing(fit) * _F(k) for k in
                             range(-2, 3)), key=lambda s: (O * s != L).sum())
                R = O * scale
                miss = np.flatnonzero(R.ravel() != L.ravel())
                if len(miss) > L.size // 10:
                    continue
                free = [f for f in free if f is not c]
                entry.update(kind=kind, key=key.tolist(), scale=float(scale),
                             a=a, b=b, misses=len(miss),
                             repro_sha256=_sha(R))
                arrays[name + ":miss"] = miss.astype(np.uint32)
                arrays[name + ":value"] = L.ravel()[miss]
                break
            else:
                arrays[name] = L
            meta["leaves"][name] = entry
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out, **arrays)
    drawn = [v for v in meta["leaves"].values() if "kind" in v]
    return {"kind": "pack", "seed": seed, "ngf": ngf,
            "leaves": len(meta["leaves"]), "drawn": len(drawn),
            "unmatched_draws": len(free),
            "numbers": int(sum(np.prod(v["shape"])
                               for v in meta["leaves"].values())),
            "misses": int(sum(v["misses"] for v in drawn)),
            "bytes": out.stat().st_size}


def _leaf(packed: Path, name: str, entry: dict) -> tuple:
    """One leaf of the packed draw: (name, leaf, what is wrong or "")."""
    wrong = ""
    with np.load(packed) as f:
        if "kind" not in entry:
            leaf = f[name]
        else:
            shape = tuple(entry["shape"])
            O = draw(entry["kind"], np.asarray(entry["key"], np.uint32),
                     int(np.prod(shape)), entry["a"], entry["b"])
            leaf = O * _F(entry["scale"])
            if _sha(leaf) != entry["repro_sha256"]:
                wrong = "recomputation differs"
            leaf[f[name + ":miss"]] = f[name + ":value"]
            leaf = leaf.reshape(shape)
    if _sha(leaf) != entry["sha256"]:
        wrong = wrong or "leaf differs"
    return name, leaf, wrong


def load(packed: Path, workers: int = 0) -> tuple:
    """The packed draw in memory: ({net: {flat name: leaf}}, report), each
    leaf checked against JAX's SHA-256 (a leaf whose recomputation
    differs from the packing machine's is named in report["wrong"]).
    `workers` > 0 recomputes the leaves in that many processes."""
    with np.load(packed) as f:
        meta = json.loads(bytes(f["meta"]).decode())
    jobs = sorted(((packed, name, entry)          # the largest first
                   for name, entry in meta["leaves"].items()),
                  key=lambda job: -int(np.prod(job[2]["shape"])))
    if workers > 0:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        with ProcessPoolExecutor(workers, multiprocessing.get_context(
                "spawn")) as pool:
            leaves = list(pool.map(_leaf, *zip(*jobs)))
    else:
        leaves = [_leaf(*job) for job in jobs]
    nets = {net: {} for net in NETS}
    wrong = {}
    for name, leaf, why in leaves:
        net, path = name.split(":")
        nets[net][path] = leaf
        if why:
            wrong[name] = why
    return nets, {"seed": meta["seed"], "ngf": meta["ngf"],
                  "leaves": len(meta["leaves"]), "exact": not wrong,
                  "wrong": wrong}


def unpack(packed: Path, root: Path) -> dict:
    """The packed draw to root/s<seed>/<net>.npz (load's check)."""
    nets, report = load(packed)
    out = root / f"s{report['seed']}"
    out.mkdir(parents=True, exist_ok=True)
    for net, flat in nets.items():
        np.savez(out / f"{net}.npz", **flat)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("pack")
    p.add_argument("--ngf", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--size", type=int, default=128,
                   help="fine_size (64: protocol_spread.py --rehearse)")
    p.add_argument("--out", required=True)
    u = sub.add_parser("unpack")
    u.add_argument("packed")
    u.add_argument("root")
    args = ap.parse_args(argv)
    if args.cmd == "pack":
        import common  # noqa: F401  (the repository on sys.path)
        res = pack(Path(args.out), args.ngf, args.seed, args.size)
    else:
        res = unpack(Path(args.packed), Path(args.root))
    print(json.dumps(res))
    return 0 if res.get("exact", True) else 1


if __name__ == "__main__":
    raise SystemExit(main())
