"""BLS12-381 pairing and signatures, from scratch (component N1).

The reference's signature layer — ``bls.Verify`` for deposits
(pos-evolution.md:165), aggregate attestation signatures over
``aggregation_bits`` (:714-717), sync aggregates (:642) — is real
BLS12-381 in every deployment. This module implements the full pairing
stack in pure Python integers as the *correctness oracle* for the native
and TPU kernels (SURVEY.md §2.7 N1):

- the field tower Fq -> Fq2 (u^2 = -1) -> Fq6 (v^3 = u+1) -> Fq12 (w^2 = v)
- curve arithmetic on E(Fq): y^2 = x^3 + 4 (G1) and the sextic M-twist
  E'(Fq2): y^2 = x^3 + 4(u+1) (G2), with subgroup cofactor clearing
- the ate pairing: generic Miller loop over the untwisted points with the
  BLS parameter t = -0xd201000000010000, final exponentiation by
  (q^12 - 1) / r
- min-pubkey-size signatures: pk in G1 (48 B compressed), signatures in G2
  (96 B compressed), hash-to-G2 by try-and-increment + cofactor clearing
  (deterministic; NOT the IETF hash_to_curve ciphersuite — the protocol
  simulator only needs a consistent, sound scheme), aggregation by G2 sum.

Slow by design (~1 s/pairing): protocol tests run on FakeBLS; this backend
exists so crypto tests and future accelerated kernels have exact vectors.
"""

from __future__ import annotations

import hashlib
import os

# --- parameters ---------------------------------------------------------------

Q = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
BLS_X = 0xD201000000010000  # |t|; t is negative for BLS12-381

G1_COFACTOR = 0x396C8C005555E1568C00AAAB0000AAAB
G2_COFACTOR = 0x5D543A95414E7F1091D50792876A202CD91DE4547085ABAA68A205B2E5A7DDFA628F1CB4D9E82EF21537E293A6691AE1616EC6E786F0C70CF1C38E31C7238E5

G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
_G2X = (0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E)
_G2Y = (0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE)


# --- Fq -----------------------------------------------------------------------

def fq_inv(a: int) -> int:
    return pow(a, Q - 2, Q)


# --- Fq2: a + b*u with u^2 = -1 ----------------------------------------------

class Fq2:
    __slots__ = ("a", "b")

    def __init__(self, a: int, b: int = 0):
        self.a = a % Q
        self.b = b % Q

    def __add__(s, o):
        return Fq2(s.a + o.a, s.b + o.b)

    def __sub__(s, o):
        return Fq2(s.a - o.a, s.b - o.b)

    def __neg__(s):
        return Fq2(-s.a, -s.b)

    def __mul__(s, o):
        if isinstance(o, int):
            return Fq2(s.a * o, s.b * o)
        t0 = s.a * o.a
        t1 = s.b * o.b
        t2 = (s.a + s.b) * (o.a + o.b)
        return Fq2(t0 - t1, t2 - t0 - t1)

    __rmul__ = __mul__

    def sq(s):
        # (a+bu)^2 = (a+b)(a-b) + 2ab u
        return Fq2((s.a + s.b) * (s.a - s.b), 2 * s.a * s.b)

    def inv(s):
        d = fq_inv((s.a * s.a + s.b * s.b) % Q)
        return Fq2(s.a * d, -s.b * d)

    def conj(s):
        return Fq2(s.a, -s.b)

    def __eq__(s, o):
        return isinstance(o, Fq2) and s.a == o.a and s.b == o.b

    def __hash__(s):
        return hash((s.a, s.b))

    def is_zero(s):
        return s.a == 0 and s.b == 0

    def pow(s, e: int):
        out, base = FQ2_ONE, s
        while e:
            if e & 1:
                out = out * base
            base = base.sq()
            e >>= 1
        return out

    def __repr__(s):
        return f"Fq2({hex(s.a)}, {hex(s.b)})"


FQ2_ZERO = Fq2(0)
FQ2_ONE = Fq2(1)
XI = Fq2(1, 1)  # the sextic twist parameter u + 1

# G2 generator (constructed here because Fq2 must exist first)
G2_GEN = (Fq2(*_G2X), Fq2(*_G2Y))


def fq2_sqrt(a: Fq2):
    """Square root in Fq2 (q^2 = 9 mod 16 method); None if non-residue."""
    cand = a.pow((Q * Q + 7) // 16)
    for root in _EIGHTH_ROOTS:
        x = cand * root
        if x.sq() == a:
            return x
    return None


def _compute_eighth_roots():
    # powers of a primitive 8th root of unity: (u+1)^((q^2-1)/8) generates
    # them since u+1 is a non-residue
    base = XI.pow((Q * Q - 1) // 8)
    roots = [FQ2_ONE]
    for _ in range(3):
        roots.append(roots[-1] * base)
    return roots


_EIGHTH_ROOTS = _compute_eighth_roots()


# --- Fq6: a + b*v + c*v^2 over Fq2 with v^3 = XI ------------------------------

class Fq6:
    __slots__ = ("a", "b", "c")

    def __init__(self, a: Fq2, b: Fq2, c: Fq2):
        self.a, self.b, self.c = a, b, c

    def __add__(s, o):
        return Fq6(s.a + o.a, s.b + o.b, s.c + o.c)

    def __sub__(s, o):
        return Fq6(s.a - o.a, s.b - o.b, s.c - o.c)

    def __neg__(s):
        return Fq6(-s.a, -s.b, -s.c)

    def __mul__(s, o):
        if isinstance(o, Fq2):
            return Fq6(s.a * o, s.b * o, s.c * o)
        t0 = s.a * o.a
        t1 = s.b * o.b
        t2 = s.c * o.c
        return Fq6(
            t0 + ((s.b + s.c) * (o.b + o.c) - t1 - t2) * XI,
            (s.a + s.b) * (o.a + o.b) - t0 - t1 + t2 * XI,
            (s.a + s.c) * (o.a + o.c) - t0 - t2 + t1,
        )

    def sq(s):
        return s * s

    def mul_by_v(s):
        return Fq6(s.c * XI, s.a, s.b)

    def inv(s):
        # standard cubic-extension inverse
        c0 = s.a.sq() - s.b * s.c * XI
        c1 = s.c.sq() * XI - s.a * s.b
        c2 = s.b.sq() - s.a * s.c
        t = (s.a * c0 + (s.c * c1 + s.b * c2) * XI).inv()
        return Fq6(c0 * t, c1 * t, c2 * t)

    def __eq__(s, o):
        return s.a == o.a and s.b == o.b and s.c == o.c

    def is_zero(s):
        return s.a.is_zero() and s.b.is_zero() and s.c.is_zero()


FQ6_ZERO = Fq6(FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = Fq6(FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


# --- Fq12: a + b*w over Fq6 with w^2 = v --------------------------------------

class Fq12:
    __slots__ = ("a", "b")

    def __init__(self, a: Fq6, b: Fq6):
        self.a, self.b = a, b

    def __add__(s, o):
        return Fq12(s.a + o.a, s.b + o.b)

    def __sub__(s, o):
        return Fq12(s.a - o.a, s.b - o.b)

    def __mul__(s, o):
        t0 = s.a * o.a
        t1 = s.b * o.b
        return Fq12(t0 + t1.mul_by_v(),
                    (s.a + s.b) * (o.a + o.b) - t0 - t1)

    def sq(s):
        return s * s

    def inv(s):
        t = (s.a * s.a - (s.b * s.b).mul_by_v()).inv()
        return Fq12(s.a * t, -(s.b * t))

    def conj(s):
        """Conjugation = Frobenius^6: a - b*w."""
        return Fq12(s.a, -s.b)

    def pow(s, e: int):
        out, base = FQ12_ONE, s
        while e:
            if e & 1:
                out = out * base
            base = base.sq()
            e >>= 1
        return out

    def __eq__(s, o):
        return s.a == o.a and s.b == o.b

    def is_one(s):
        return s == FQ12_ONE


FQ12_ONE = Fq12(FQ6_ONE, FQ6_ZERO)


def fq2_to_fq12(x: Fq2) -> Fq12:
    return Fq12(Fq6(x, FQ2_ZERO, FQ2_ZERO), FQ6_ZERO)


# w and its powers for the untwist map psi(x', y') = (x'/w^2, y'/w^3)
_W = Fq12(FQ6_ZERO, FQ6_ONE)
_W2_INV = (_W * _W).inv()
_W3_INV = (_W * _W * _W).inv()


# --- generic curve arithmetic (affine, over any of the fields) ----------------

def ec_add(p1, p2, zero=None):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 == y2:
            return ec_double(p1)
        return None  # P + (-P)
    lam = (y2 - y1) * _inv_of(x2 - x1)
    if isinstance(x1, int):
        lam %= Q
        x3 = (lam * lam - x1 - x2) % Q
        return (x3, (lam * (x1 - x3) - y1) % Q)
    x3 = lam * lam - x1 - x2
    return (x3, lam * (x1 - x3) - y1)


def ec_double(p):
    if p is None:
        return None
    x, y = p
    lam = 3 * (x * x) * _inv_of(2 * y) if isinstance(x, int) else \
        (x * x * 3) * _inv_of(y * 2)
    if isinstance(x, int):
        lam %= Q
    x3 = lam * lam - x - x
    if isinstance(x, int):
        x3 %= Q
        return (x3, (lam * (x - x3) - y) % Q)
    return (x3, lam * (x - x3) - y)


def _inv_of(v):
    if isinstance(v, int):
        return fq_inv(v % Q)
    return v.inv()


def ec_mul(p, k: int):
    out = None
    add = p
    while k:
        if k & 1:
            out = ec_add(out, add)
        add = ec_double(add)
        k >>= 1
    return out


def ec_neg(p):
    if p is None:
        return None
    x, y = p
    return (x, (-y) % Q if isinstance(y, int) else -y)


def g1_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - x * x * x - 4) % Q == 0


def g2_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return y.sq() - x.sq() * x == Fq2(4, 4)


def subgroup_check_g1(p) -> bool:
    return g1_on_curve(p) and ec_mul(p, R) is None


def subgroup_check_g2(p) -> bool:
    return g2_on_curve(p) and ec_mul(p, R) is None


# --- pairing ------------------------------------------------------------------

def _untwist(q):
    """E'(Fq2) -> E(Fq12): (x, y) -> (x/w^2, y/w^3)."""
    x, y = q
    return (fq2_to_fq12(x) * _W2_INV, fq2_to_fq12(y) * _W3_INV)


def _line(a, b, px, py) -> Fq12:
    """Line through a, b (E(Fq12) points) evaluated at (px, py)."""
    xa, ya = a
    xb, yb = b
    if not (xa == xb):
        lam = (yb - ya) * (xb - xa).inv()
        return (px - xa) * lam - (py - ya)
    if ya == yb:
        lam = (xa * xa * Fq12(Fq6(Fq2(3), FQ2_ZERO, FQ2_ZERO), FQ6_ZERO)) \
            * (ya + ya).inv()
        return (px - xa) * lam - (py - ya)
    return px - xa


def miller_loop(q_twisted, p_g1) -> Fq12:
    """Ate Miller loop for e(P, Q) with P in G1, Q in G2 (twisted coords)."""
    if q_twisted is None or p_g1 is None:
        return FQ12_ONE
    qx, qy = _untwist(q_twisted)
    px = fq2_to_fq12(Fq2(p_g1[0]))
    py = fq2_to_fq12(Fq2(p_g1[1]))
    r_pt = (qx, qy)
    f = FQ12_ONE
    for bit in bin(BLS_X)[3:]:
        f = f * f * _line(r_pt, r_pt, px, py)
        r_pt = _ec12_double(r_pt)
        if bit == "1":
            f = f * _line(r_pt, (qx, qy), px, py)
            r_pt = _ec12_add(r_pt, (qx, qy))
    # BLS parameter t is negative: conjugate
    return f.conj()


def _ec12_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 == y2:
            return _ec12_double(p1)
        return None
    lam = (y2 - y1) * (x2 - x1).inv()
    x3 = lam * lam - x1 - x2
    return (x3, lam * (x1 - x3) - y1)


def _ec12_double(p):
    x, y = p
    three = Fq12(Fq6(Fq2(3), FQ2_ZERO, FQ2_ZERO), FQ6_ZERO)
    lam = (x * x * three) * (y + y).inv()
    x3 = lam * lam - x - x
    return (x3, lam * (x - x3) - y)


_FINAL_EXP = (Q**12 - 1) // R


def pairing(p_g1, q_g2) -> Fq12:
    """e(P, Q) for P in G1 (affine ints), Q in G2 (affine Fq2)."""
    return miller_loop(q_g2, p_g1).pow(_FINAL_EXP)


def pairings_equal(pairs_a, pairs_b) -> bool:
    """Check prod e(a) == prod e(b) via one final exponentiation."""
    f = FQ12_ONE
    for p, q in pairs_a:
        f = f * miller_loop(q, p)
    for p, q in pairs_b:
        f = f * miller_loop(ec_neg_g2(q), p)
    return f.pow(_FINAL_EXP).is_one()


def ec_neg_g2(q):
    if q is None:
        return None
    x, y = q
    return (x, -y)


# --- hash to G2 (try-and-increment + cofactor clearing) -----------------------

_G2_DST = b"blsg2"


def _g2_cache_path(message: bytes, dst: bytes):
    """Cache file for one (message, dst) pair, or None when the
    ``POS_G2_CACHE_DIR`` knob is unset (the default: no disk IO)."""
    cache_dir = os.environ.get("POS_G2_CACHE_DIR")
    if not cache_dir:
        return None
    key = hashlib.sha256(b"g2cache-v1\x00" + dst + b"\x00" + message)
    return os.path.join(cache_dir, f"g2_{key.hexdigest()}.bin")


def _g2_cache_load(path: str):
    """Stored point, or None on miss/corruption (caller recomputes)."""
    try:
        with open(path, "rb") as fh:
            raw = fh.read()
    except OSError:
        return None
    if len(raw) != 192:
        return None
    a, b, c, d = (int.from_bytes(raw[i:i + 48], "big")
                  for i in range(0, 192, 48))
    point = (Fq2(a, b), Fq2(c, d))
    if max(a, b, c, d) >= Q or not g2_on_curve(point):
        return None
    return point


def _g2_cache_store(path: str, point) -> None:
    """Atomic tmp+rename write; cache misses must never break signing."""
    x, y = point
    raw = b"".join(v.to_bytes(48, "big") for v in (x.a, x.b, y.a, y.b))
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as fh:
            fh.write(raw)
        os.replace(tmp, path)
    except OSError:
        pass


def hash_to_g2(message: bytes, dst: bytes = _G2_DST):
    """Deterministic map to the r-torsion of E'(Fq2).

    NOT the IETF SSWU ciphersuite; a sound simple construction for the
    simulator: derive x candidates from H(dst || message || ctr), solve
    y^2 = x^3 + 4(u+1), clear the cofactor.

    The cofactor clearing is the dominant cost (~a full-width ec_mul),
    so results are disk-cached keyed on (message, dst) when the
    ``POS_G2_CACHE_DIR`` environment knob names a directory — repeated
    runs over the same message population (chaos episodes, CI smoke
    jobs) skip straight to the stored point. Corrupt or truncated
    cache entries fail closed into recomputation.
    """
    path = _g2_cache_path(message, dst)
    if path is not None:
        cached = _g2_cache_load(path)
        if cached is not None:
            return cached
    ctr = 0
    while True:
        seed = hashlib.sha256(dst + message + ctr.to_bytes(4, "little"))
        d0 = seed.digest()
        d1 = hashlib.sha256(d0).digest()
        d2 = hashlib.sha256(d1).digest()
        x = Fq2(int.from_bytes(d0 + d1[:16], "big"),
                int.from_bytes(d1[16:] + d2, "big"))
        rhs = x.sq() * x + Fq2(4, 4)
        y = fq2_sqrt(rhs)
        if y is not None:
            # canonical sign
            if y.a % 2 == 1:
                y = -y
            point = ec_mul((x, y), G2_COFACTOR)
            if point is not None:
                if path is not None:
                    _g2_cache_store(path, point)
                return point
        ctr += 1


# --- serialization (ZCash-style compressed points) ----------------------------

_FLAG_COMPRESSED = 1 << 383
_FLAG_INFINITY = 1 << 382
_FLAG_SIGN = 1 << 381


def _y_is_large(y: int) -> bool:
    return y > (Q - 1) // 2


def g1_compress(p) -> bytes:
    if p is None:
        return ((_FLAG_COMPRESSED | _FLAG_INFINITY) >> 0).to_bytes(48, "big")
    x, y = p
    bits = x | _FLAG_COMPRESSED | (_FLAG_SIGN if _y_is_large(y) else 0)
    return bits.to_bytes(48, "big")


def g1_decompress(data: bytes):
    bits = int.from_bytes(data, "big")
    if bits & _FLAG_INFINITY:
        return None
    sign_large = bool(bits & _FLAG_SIGN)
    x = bits & ((1 << 381) - 1)
    y2 = (pow(x, 3, Q) + 4) % Q
    y = pow(y2, (Q + 1) // 4, Q)
    if (y * y) % Q != y2:
        raise ValueError("invalid G1 point")
    if _y_is_large(y) != sign_large:
        y = Q - y
    return (x, y)


def g2_compress(p) -> bytes:
    if p is None:
        hi = (_FLAG_COMPRESSED | _FLAG_INFINITY).to_bytes(48, "big")
        return hi + b"\x00" * 48
    x, y = p
    # sign flag: y lexicographically greater than -y (compare (b, a))
    sign_large = (y.b, y.a) > ((Q - y.b) % Q, (Q - y.a) % Q)
    hi = x.b | _FLAG_COMPRESSED | (_FLAG_SIGN if sign_large else 0)
    return hi.to_bytes(48, "big") + x.a.to_bytes(48, "big")


def g2_decompress(data: bytes):
    hi = int.from_bytes(data[:48], "big")
    if hi & _FLAG_INFINITY:
        return None
    sign_large = bool(hi & _FLAG_SIGN)
    x = Fq2(int.from_bytes(data[48:], "big"), hi & ((1 << 381) - 1))
    y = fq2_sqrt(x.sq() * x + Fq2(4, 4))
    if y is None:
        raise ValueError("invalid G2 point")
    if ((y.b, y.a) > ((Q - y.b) % Q, (Q - y.a) % Q)) != sign_large:
        y = -y
    return (x, y)


# --- the BLS signature scheme (min-pubkey-size) -------------------------------

class PyBLS:
    """Real BLS12-381 backend with the crypto/bls.py interface."""

    name = "bls12_381"

    @staticmethod
    def SkToPk(sk: int) -> bytes:
        return g1_compress(ec_mul(G1_GEN, sk % R))

    @staticmethod
    def Sign(sk: int, message: bytes) -> bytes:
        return g2_compress(ec_mul(hash_to_g2(bytes(message)), sk % R))

    @staticmethod
    def Verify(pubkey: bytes, message: bytes, signature: bytes) -> bool:
        try:
            pk = g1_decompress(bytes(pubkey))
            sig = g2_decompress(bytes(signature))
        except ValueError:
            return False
        if pk is None or sig is None or not subgroup_check_g2(sig):
            return False
        h = hash_to_g2(bytes(message))
        # e(pk, H(m)) == e(g1, sig)
        return pairings_equal([(pk, h)], [(G1_GEN, sig)])

    @staticmethod
    def Aggregate(signatures) -> bytes:
        acc = None
        for s in signatures:
            acc = ec_add(acc, g2_decompress(bytes(s)))
        return g2_compress(acc)

    @staticmethod
    def AggregatePKs(pubkeys) -> bytes:
        acc = None
        for pk in pubkeys:
            acc = ec_add(acc, g1_decompress(bytes(pk)))
        return g1_compress(acc)

    @classmethod
    def FastAggregateVerify(cls, pubkeys, message: bytes, signature: bytes) -> bool:
        if not pubkeys:
            return False
        return cls.Verify(cls.AggregatePKs(pubkeys), message, signature)

    @classmethod
    def AggregateVerify(cls, pubkeys, messages, signature: bytes) -> bool:
        if not pubkeys or len(pubkeys) != len(messages):
            return False
        try:
            sig = g2_decompress(bytes(signature))
        except ValueError:
            return False
        if sig is None or not subgroup_check_g2(sig):
            return False
        pairs = [(g1_decompress(bytes(pk)), hash_to_g2(bytes(m)))
                 for pk, m in zip(pubkeys, messages)]
        return pairings_equal(pairs, [(G1_GEN, sig)])
