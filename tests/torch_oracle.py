"""A jax-free copy of tests/test_kat.py's exact Python-integer oracle.

The class Oracle is tests/test_kat.py's, text for text
(tests/test_torch_kat.py holds the two equal): a model of the CKKS engine
in exact Python integers that consumes the same Surf() stream through the
same samplers, so that every ciphertext of the engine can be held limb for
limb against it.  It imports the port's verbatim copies of the host modules
(context, ring/sample, substrate/surf, params) and neither jax nor
gpqhe_tpu, so it also runs on a machine that has only the port: the CUDA
tests (tests/test_torch_cuda.py) hold the engine on the card against it.

kat_sequence and ladder_sweep are the op sequences of test_kat.py's
test_exact_oracle_kat and test_exact_oracle_ladder_sweep, written once for
any engine.  ct_ints is its _ct_ints for the port's ciphertexts (limb
tensors on any device are read back to the host first); first_mismatch
takes the place of its _assert_ct_equal and returns the first differing
coefficient instead of raising, so that a run on the card can report every
ciphertext before it fails.
"""

from gpqhe_tpu_torch import params
from gpqhe_tpu_torch.context import HeContext
from gpqhe_tpu_torch.ring import sample as smp
from gpqhe_tpu_torch.scheme.types import limbs_to_numpy
from gpqhe_tpu_torch.substrate import bigint
from gpqhe_tpu_torch.substrate.surf import Surf

# the rings of test_exact_oracle_kat and test_exact_oracle_ladder_sweep
KAT_RING = dict(logn=4, q=1 << 610, slots=2, Delta=1 << 30)
LADDER_RING = dict(logn=5, q=1 << 610, slots=2, Delta=1 << 30)


class Oracle:
    """Python-int model of the CKKS engine with identical surf consumption."""

    def __init__(self, ctx: HeContext):
        self.ctx = ctx
        self.rng = Surf()
        self.n = ctx.poly.n

    # -- ring ----------------------------------------------------------------

    def negacyclic(self, a, b):
        n = self.n
        out = [0] * n
        for i in range(n):
            ai = a[i]
            if ai == 0:
                continue
            for j in range(n):
                k = i + j
                if k < n:
                    out[k] += ai * b[j]
                else:
                    out[k - n] -= ai * b[j]
        return out

    def galois(self, a, rot, qb):
        """rot=None -> conjugation (ref: src/poly.c:263-283)."""
        n, m = self.n, 2 * self.n
        mod = 1 << qb
        out = [0] * n
        if rot is None:
            out[0] = a[0] % mod
            for i in range(1, n):
                out[i] = (-a[n - i]) % mod
        else:
            power = pow(params.ROT, rot, m)
            for i in range(n):
                k = (i * power) % m
                if k < n:
                    out[k] = a[i] % mod
                else:
                    out[k - n] = (-a[i]) % mod
        return out

    # -- keygen (sampling order mirrors scheme/engine.py exactly) ------------

    def keypair(self):
        ctx = self.ctx
        qb = ctx.q[ctx.L].bit_length()
        self.s = [int(x) for x in smp.sample_sk(self.rng, self.n)]
        e = [int(x) for x in smp.sample_error(self.rng, self.n)]
        p1 = smp.sample_uniform_ints(self.rng, self.n, ctx.q[ctx.L])
        prod = self.negacyclic(self.s, p1)
        p0 = [(-c + ei) % (1 << qb) for c, ei in zip(prod, e)]
        self.pk = (p0, p1)

    def genswk(self, sp):
        ctx = self.ctx
        PqL = ctx.PqL
        e = [int(x) for x in smp.sample_error(self.rng, self.n)]
        swkp1 = smp.sample_uniform_ints(self.rng, self.n, PqL)
        prod = self.negacyclic(swkp1, self.s)
        swkp0 = [(-c + ei + ctx.P * spi) % PqL
                 for c, ei, spi in zip(prod, e, sp)]
        return (swkp0, swkp1)

    def genrlk(self):
        s2 = self.negacyclic(self.s, self.s)
        self.rlk = self.genswk(s2)

    def genck(self):
        n = self.n
        conj = [self.s[0]] + [-self.s[n - i] for i in range(1, n)]
        self.ck = self.genswk(conj)

    def genrk(self, rotations):
        n, m = self.n, 2 * self.n
        self.rk = {}
        for rot in rotations:
            power = pow(params.ROT, rot, m)
            rk = [0] * n
            for i in range(n):
                k = (i * power) % m
                if k < n:
                    rk[k] = self.s[i]
                else:
                    rk[k - n] = -self.s[i]
            self.rk[rot] = self.genswk(rk)

    # -- encrypt --------------------------------------------------------------

    def enc_pk(self, m):
        ctx = self.ctx
        qb = ctx.q[ctx.L].bit_length()
        mod = 1 << qb
        v = [int(x) for x in smp.sample_zo(self.rng, self.n)]
        e0 = [int(x) for x in smp.sample_error(self.rng, self.n)]
        e1 = [int(x) for x in smp.sample_error(self.rng, self.n)]
        c0 = self.negacyclic(self.pk[0], v)
        c1 = self.negacyclic(self.pk[1], v)
        c0 = [(c + mi + ei) % mod for c, mi, ei in zip(c0, m, e0)]
        c1 = [(c + ei) % mod for c, ei in zip(c1, e1)]
        return (ctx.L, c0, c1)

    def enc_sk(self, m):
        ctx = self.ctx
        qb = ctx.q[ctx.L].bit_length()
        mod = 1 << qb
        e = [int(x) for x in smp.sample_error(self.rng, self.n)]
        c1 = smp.sample_uniform_ints(self.rng, self.n, ctx.q[ctx.L])
        prod = self.negacyclic(c1, self.s)
        c0 = [(-c + mi + ei) % mod for c, mi, ei in zip(prod, m, e)]
        return (ctx.L, c0, c1)

    def dec(self, ct):
        l, c0, c1 = ct
        qb = self.ctx.q[l].bit_length()
        prod = self.negacyclic(c1, self.s)
        return [(p + c) % (1 << qb) for p, c in zip(prod, c0)]

    # -- scheme ops -----------------------------------------------------------

    def add(self, ct1, ct2):
        l = ct1[0]
        mod = 1 << self.ctx.q[l].bit_length()
        return (l, [(a + b) % mod for a, b in zip(ct1[1], ct2[1])],
                [(a + b) % mod for a, b in zip(ct1[2], ct2[2])])

    def keyswitch(self, d, swk, l):
        """u_h = rdiv(d (*) swk_h, P) mod 2^qb (engine _keyswitch_core)."""
        ctx = self.ctx
        mod = 1 << ctx.q[l].bit_length()
        P = ctx.P
        out = []
        for h in range(2):
            c = self.negacyclic(d, swk[h])
            u = [(ci // P) + (1 if (ci % P) > P // 2 else 0) for ci in c]
            out.append([ui % mod for ui in u])
        return out

    def mul(self, ct1, ct2):
        """he_mul + he_relin (ref: src/he-mult.c:88-156)."""
        assert ct1[0] == ct2[0]
        l = ct1[0]
        mod = 1 << self.ctx.q[l].bit_length()
        d0 = [x % mod for x in self.negacyclic(ct1[1], ct2[1])]
        d2 = [x % mod for x in self.negacyclic(ct1[2], ct2[2])]
        d1a = self.negacyclic(ct1[1], ct2[2])
        d1b = self.negacyclic(ct1[2], ct2[1])
        d1 = [(a + b) % mod for a, b in zip(d1a, d1b)]
        u0, u1 = self.keyswitch(d2, self.rlk, l)
        c0 = [(u + d) % mod for u, d in zip(u0, d0)]
        c1 = [(u + d) % mod for u, d in zip(u1, d1)]
        return (l, c0, c1)

    def rs(self, ct):
        """Shift+round by Delta=2^logD on the nonneg representative, ties
        down, then mask to q_{l-1} width (engine rs / lb.rshift_round)."""
        l, c0, c1 = ct
        logD = self.ctx.p.bit_length() - 1
        mod = 1 << self.ctx.q[l - 1].bit_length()
        half = 1 << (logD - 1)

        def one(c):
            return [((x >> logD) + (1 if (x & ((1 << logD) - 1)) > half else 0))
                    % mod for x in c]
        return (l - 1, one(c0), one(c1))

    def moddown(self, ct):
        l, c0, c1 = ct
        mod = 1 << self.ctx.q[l - 1].bit_length()
        return (l - 1, [x % mod for x in c0], [x % mod for x in c1])

    def conj(self, ct):
        l, c0, c1 = ct
        qb = self.ctx.q[l].bit_length()
        d0 = self.galois(c0, None, qb)
        d1 = self.galois(c1, None, qb)
        u0, u1 = self.keyswitch(d1, self.ck, l)
        mod = 1 << qb
        return (l, [(u + d) % mod for u, d in zip(u0, d0)], u1)

    def rot(self, ct, r):
        l, c0, c1 = ct
        qb = self.ctx.q[l].bit_length()
        d0 = self.galois(c0, r, qb)
        d1 = self.galois(c1, r, qb)
        u0, u1 = self.keyswitch(d1, self.rk[r], l)
        mod = 1 << qb
        return (l, [(u + d) % mod for u, d in zip(u0, d0)], u1)



def signed_message(pt, to_host=limbs_to_numpy) -> list:
    """A plaintext's limbs as the signed integers the oracle encrypts."""
    mod_pt = 1 << pt.mod_bits
    return [(v % mod_pt) - mod_pt if (v % mod_pt) >= mod_pt // 2 else v % mod_pt
            for v in bigint.limbs_to_ints(to_host(pt.m))]


def ct_ints(eng, ct, to_host=limbs_to_numpy):
    """Engine ciphertext -> (l, c0 ints, c1 ints) reduced mod 2^qbits."""
    mod = 1 << eng.qbits(ct.l)
    c0 = [v % mod for v in bigint.limbs_to_ints(to_host(ct.c0))]
    c1 = [v % mod for v in bigint.limbs_to_ints(to_host(ct.c1))]
    return ct.l, c0, c1


def first_mismatch(eng, ct, oct_, to_host=limbs_to_numpy):
    """None where the ciphertext equals the oracle's, else (half, index)
    of the first coefficient that differs (or the levels)."""
    l, c0, c1 = ct_ints(eng, ct, to_host)
    if l != oct_[0]:
        return ("level", l, oct_[0])
    for half, got, want in (("c0", c0, oct_[1]), ("c1", c1, oct_[2])):
        for i, (a, b) in enumerate(zip(got, want)):
            if a != b:
                return (half, i)
    return None


def _ints(t, to_host):
    return bigint.limbs_to_ints(to_host(t))


def _check(ok, what: str) -> None:
    """A gate that also holds under python -O."""
    if not ok:
        raise AssertionError(what)


def kat_sequence(eng, orc=None, to_host=limbs_to_numpy) -> list:
    """test_exact_oracle_kat's sequence (keygen, ecd, enc_pk, enc_sk, dec,
    add, mul, rs, moddown, conj, rot(1), mul_rs) on eng, and with orc on the
    oracle beside it.  Holds the secret key, pk.p0 and the decryption
    against the oracle inline; returns [(name, ciphertext, oracle
    ciphertext or None)].  to_host reads a limb array of eng's back to
    numpy (the JAX engine's: np.asarray)."""
    ctx = eng.ctx
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    ck = eng.genck(sk)
    rk = eng.genrk(sk, rotations=[0, 1])
    m0 = smp.sample_z01vec(eng.rng, ctx.slots)
    pt = eng.ecd(m0)
    ct = eng.enc_pk(pt, pk)
    ct_sk = eng.enc_sk(pt, sk)
    ct_mul = eng.mul(ct, ct_sk, rlk)
    ct_rs = eng.rs(ct_mul)
    cts = {"enc_pk": ct, "enc_sk": ct_sk, "add": eng.add(ct, ct_sk), "mul+relin": ct_mul,
           "rescale": ct_rs, "moddown": eng.moddown(ct_rs), "conj": eng.conj(ct.copy(), ck),
           "rot1": eng.rot(ct.copy(), 1, rk), "mul_rs": eng.mul_rs(ct, ct_sk, rlk)}
    if orc is None:
        return [(name, c, None) for name, c in cts.items()]

    orc.keypair()
    s_ints = [v - (1 << 32) if v >= (1 << 31) else v for v in _ints(sk.s, to_host)]
    _check(s_ints == orc.s, "secret key stream mismatch")
    qbL = eng.qbits(ctx.L)
    _check([v % (1 << qbL) for v in _ints(pk.p0, to_host)]
           == [v % (1 << qbL) for v in orc.pk[0]], "pk.p0 mismatch")
    orc.genrlk()
    orc.genck()
    orc.genrk([0, 1])
    _check((smp.sample_z01vec(orc.rng, ctx.slots) == m0).all(), "message stream mismatch")
    m_signed = signed_message(pt, to_host)
    o = {"enc_pk": orc.enc_pk(m_signed), "enc_sk": orc.enc_sk(m_signed)}
    modq = 1 << (eng.qbits(ct.l) - 1)
    _check([v % modq for v in _ints(eng.dec(ct, sk).m, to_host)]
           == [v % modq for v in orc.dec(o["enc_pk"])], "dec mismatch")
    o["add"] = orc.add(o["enc_pk"], o["enc_sk"])
    o["mul+relin"] = orc.mul(o["enc_pk"], o["enc_sk"])
    o["rescale"] = orc.rs(o["mul+relin"])
    o["moddown"] = orc.moddown(o["rescale"])
    o["conj"] = orc.conj(o["enc_pk"])
    o["rot1"] = orc.rot(o["enc_pk"], 1)
    o["mul_rs"] = o["rescale"]
    return [(name, c, o[name]) for name, c in cts.items()]


def ladder_sweep(eng, orc, to_host=limbs_to_numpy) -> list:
    """test_exact_oracle_ladder_sweep's sequence: keygen, enc_pk, then conj
    and mul_rs(ct, conj(ct)) at every level down to 0, on eng and on the
    oracle beside it.  Returns [(name, ciphertext, oracle ciphertext)]."""
    ctx = eng.ctx
    pk, sk = eng.keypair()
    rlk = eng.genrlk(sk)
    ck = eng.genck(sk)
    m0 = smp.sample_z01vec(eng.rng, ctx.slots)
    pt = eng.ecd(m0)
    ct = eng.enc_pk(pt, pk)
    out = [("enc_pk", ct)]
    while ct.l >= 1:
        l = ct.l
        ct_c = eng.conj(ct.copy(), ck)
        ct = eng.mul_rs(ct, ct_c, rlk)
        out += [(f"conj@l={l}", ct_c), (f"mul_rs@l={l}", ct)]
    orc.keypair()
    orc.genrlk()
    orc.genck()
    smp.sample_z01vec(orc.rng, ctx.slots)
    oct_ = orc.enc_pk(signed_message(pt, to_host))
    o = [oct_]
    while oct_[0] >= 1:
        oct_c = orc.conj(oct_)
        oct_ = orc.rs(orc.mul(oct_, oct_c))
        o += [oct_c, oct_]
    _check(len(o) == len(out), f"{len(o)} oracle ciphertexts, {len(out)} engine's")
    return [(name, c, oc) for (name, c), oc in zip(out, o)]
