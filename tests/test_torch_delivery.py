"""The port's delivery surface and the protocol's native chain, on the
CPU at K=7: key and proof serialisation, `rebind_witness`, the ceremony
SRS file, the KZG accumulator against the JAX package's, a two-round
`RecursionChain`, and the CLI's and the proving service's surfaces.

One module fixture loads the dev SRS from the frozen JAX arrays (the
port's own generation of it is held to them by tests/test_torch_prover.py),
makes two toy circuits whose public instances follow the protocol layout
(voter 30, state transition 70; prover/recursion.py:74-85) and three
proofs: the voter's through a key saved, loaded and rebound to a new
witness, and two state transitions whose roots and tallies chain.  The SRS file's sha256 is the frozen JAX
package's (`scripts/gen_torch_port_vectors.py srs_file`); the JAX
package's succinct verifier is host code and runs here.  The state
transition's synthesis at k=15, its CLI round trip at k=13 and the
server's at k=13 are `slow`.  Tolerance: none -- bytes and integers.
"""

import base64
import dataclasses
import hashlib
import json
import os
import random
import subprocess
import sys
import threading
import urllib.error
import urllib.request
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zksnap_tpu.curves.jacobian import JacPoint as JJacPoint
from zksnap_tpu.curves.native import BN254_G1 as J_BN254
from zksnap_tpu.curves.native import AffinePoint as JAffine
from zksnap_tpu.prover import accumulator as jacc
from zksnap_tpu.prover import pairing as jpairing
from zksnap_tpu.prover import plonk as jplonk
from zksnap_tpu.prover import srs as jsrs
from zksnap_tpu_torch import cli, server
from zksnap_tpu_torch.prover import (RecursionChain, Snark,
                                     accumulator_from_proof,
                                     accumulator_limbs, gen_srs, keygen,
                                     load_pk, load_srs, load_vk,
                                     proof_from_bytes, proof_to_bytes, prove,
                                     rebind_witness, save_pk, save_srs,
                                     save_vk, srs_sanity_check, verify)
from zksnap_tpu_torch.prover.plonk import P
from zksnap_tpu_torch.prover.srs import _lagrange_sum_check, srs_cache_path
from zksnap_tpu_torch.trace import Context, check

torch.set_num_threads(1)
DEV = "cpu"

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VECTORS = os.path.join(ROOT, "tests", "vectors", "torch_port_v1.json")


def _vectors(name):
    with open(VECTORS) as f:
        return json.load(f)[name]


def _toy(values):
    """A K=7 circuit exposing `values` as its instances, with a gate and
    a range check whose shapes do not depend on the values."""
    ctx = Context(lookup_bits=6)
    cells = [ctx.load_witness(v) for v in values]
    ctx.mul(cells[0], cells[1])
    ctx.range_check(ctx.load_witness(values[2] % 64), 6)
    for c in cells:
        ctx.expose_public(c)
    check(ctx, list(values))
    return ctx


def _instances(seed):
    """(voter, state round 1, state round 2) instances in the protocol
    layout: the voter's pk_enc (4), votes (20) and nullifier (4) reappear
    in both state transitions; round 2's previous tally and old root are
    round 1's new ones."""
    rng = random.Random(seed)

    def draw(n):
        return [rng.randrange(P) for _ in range(n)]

    pk_enc, votes, nullifier = draw(4), draw(20), draw(4)
    voter = pk_enc + votes + nullifier + draw(2)
    prev, aggr1, aggr2 = draw(20), draw(20), draw(20)
    old, new1, new2 = draw(3)
    state1 = pk_enc + prev + votes + aggr1 + nullifier + [old, new1]
    state2 = pk_enc + aggr1 + votes + aggr2 + nullifier + [new1, new2]
    return voter, state1, state2


def _frozen_srs_cache(cache_dir):
    """Write the frozen K=7 dev SRS arrays (the JAX package's cache file,
    vector `srs_k7_arrays`) where gen_srs looks for them, after checking
    them against the sha256 that tests/test_torch_prover.py holds the
    port's own K=7 SRS generation to."""
    v = _vectors("srs_k7_arrays")
    arrays = {name: np.frombuffer(zlib.decompress(base64.b64decode(packed)),
                                  dtype="<u4").reshape(128, 16)
              for name, packed in v["arrays"].items()}
    h = hashlib.sha256()
    for name in ("x", "y", "z", "lx", "ly", "lz"):
        h.update(arrays[name].tobytes())
    assert h.hexdigest() == v["sha256"] == _vectors("srs_k7")["sha256"]
    np.savez(srs_cache_path(7, b"dev", cache_dir), **arrays)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    d = tmp_path_factory.mktemp("delivery")
    _frozen_srs_cache(str(d))
    srs = gen_srs(7, cache_dir=str(d), device=DEV)
    voter, state1, state2 = _instances(41)
    vpk = keygen(_toy([(v + 1) % P for v in voter]), 7, srs, device=DEV)
    save_pk(vpk, str(d / "voter_pk.bin"))
    save_vk(vpk.vk, str(d / "voter_vk.bin"))
    loaded = load_pk(str(d / "voter_pk.bin"), device=DEV)
    vk = load_vk(str(d / "voter_vk.bin"))
    vproof = prove(rebind_witness(loaded, _toy(voter)), voter,
                   random.Random(1))
    spk = keygen(_toy(state1), 7, srs, device=DEV)
    s1 = prove(spk, state1, random.Random(2))
    s2 = prove(rebind_witness(spk, _toy(state2)), state2, random.Random(3))
    return dict(dir=d, srs=srs, vpk=vpk, loaded=loaded, vk=vk, spk=spk,
                voter=Snark(vk, voter, vproof),
                state1=Snark(spk.vk, state1, s1),
                state2=Snark(spk.vk, state2, s2))


def test_pk_vk_round_trip(chain):
    """The loaded key is the saved one, and a proof made from it (after a
    rebind) verifies under the loaded vk; a flipped byte does not."""
    vpk, loaded, srs = chain["vpk"], chain["loaded"], chain["srs"]
    assert chain["vk"] == vpk.vk and loaded.vk == vpk.vk
    assert sorted(loaded.fixed_coeffs) == sorted(vpk.fixed_coeffs)
    for k, v in vpk.fixed_coeffs.items():
        assert torch.equal(loaded.fixed_coeffs[k], v), k
    assert loaded.srs is srs
    snark = chain["voter"]
    assert verify(chain["vk"], srs.g2, srs.tau_g2, snark.instances,
                  snark.proof)
    bad = bytearray(snark.proof)
    bad[len(bad) // 2] ^= 1
    assert not verify(chain["vk"], srs.g2, srs.tau_g2, snark.instances,
                      bytes(bad))


def test_stripped_pk_rebinds_alike(chain):
    """strip_witness drops the keygen witness; rebinding the stripped key
    gives the layout that rebinding the full key gives."""
    path = str(chain["dir"] / "voter_pk_stripped.bin")
    save_pk(chain["vpk"], path, strip_witness=True)
    stripped = load_pk(path, device=DEV)
    assert stripped.layout.advice_limbs.shape == (0, 16)
    ctx = _toy(chain["voter"].instances)
    a = rebind_witness(stripped, ctx).layout
    b = rebind_witness(chain["vpk"], ctx).layout
    assert np.array_equal(a.advice_limbs, b.advice_limbs)
    assert list(a.multiplicity) == list(b.multiplicity)
    assert a.instance_col == b.instance_col


def test_rebind_witness(chain):
    """A proof from a rebound key binds the new witness's instances, and
    a context of another structure is refused."""
    srs, snark = chain["srs"], chain["voter"]
    assert verify(snark.vk, srs.g2, srs.tau_g2, snark.instances, snark.proof)
    old = [(v + 1) % P for v in snark.instances]
    assert not verify(snark.vk, srs.g2, srs.tau_g2, old, snark.proof)
    with pytest.raises(ValueError, match="mismatch"):
        rebind_witness(chain["vpk"], _toy(chain["state1"].instances))


def test_proof_bytes_identity(chain):
    proof = chain["voter"].proof
    assert proof_from_bytes(proof_to_bytes(bytearray(proof))) == proof
    with pytest.raises(TypeError):
        proof_to_bytes(list(proof))


def _jax_vk(vk):
    fields = {f.name: getattr(vk, f.name)
              for f in dataclasses.fields(jplonk.VerifyingKey)}
    fields["commitments"] = {
        k: JAffine.identity(J_BN254) if p.is_identity()
        else JAffine(J_BN254, p.x, p.y) for k, p in vk.commitments.items()}
    return jplonk.VerifyingKey(**fields)


@pytest.mark.parametrize("name", ["voter", "state1"])
def test_accumulator_matches_jax(chain, monkeypatch, name):
    """The port's accumulator of a port proof is the JAX package's on the
    same bytes and vk.  The JAX instance commitment takes its Lagrange
    points from the port's SRS (the same arrays, test_torch_prover.py)
    instead of generating the JAX SRS."""
    srs, snark = chain["srs"], chain[name]

    def pts(a):
        return jnp.asarray(a.numpy().astype(np.uint32))

    lag = srs.g1_lagrange
    jsrs_obj = jsrs.SRS(7, None, JJacPoint(pts(lag.x), pts(lag.y),
                                           pts(lag.z)), None, None)
    monkeypatch.setattr(jplonk, "gen_srs", lambda k, seed=b"dev": jsrs_obj)
    want = jacc.accumulator_from_proof(_jax_vk(snark.vk), snark.instances,
                                       snark.proof)
    got = accumulator_from_proof(snark.vk, snark.instances, snark.proof)
    assert want is not None and got is not None
    for g, w in ((got.lhs, want.lhs), (got.rhs, want.rhs)):
        assert not w.is_identity()
        assert (g.x, g.y) == (w.x, w.y)


def test_recursion_chain_two_rounds(chain):
    """Two rounds of (voter, state transition), folded, decided by one
    pairing."""
    srs = chain["srs"]
    rc = RecursionChain(srs.g2, srs.tau_g2)
    rc.add_round(chain["voter"], chain["state1"])
    rc.add_round(chain["voter"], chain["state2"])
    assert rc.round == 2
    assert len(accumulator_limbs(rc.acc)) == 12
    assert rc.finalize()


def test_recursion_chain_refuses_broken_links(chain):
    srs = chain["srs"]
    rc = RecursionChain(srs.g2, srs.tau_g2)
    rc.add_round(chain["voter"], chain["state2"])
    with pytest.raises(AssertionError, match="root chain broken"):
        rc.add_round(chain["voter"], chain["state1"])
    bad = bytearray(chain["state1"].proof)
    bad[100] ^= 0x10
    with pytest.raises(ValueError, match="succinct"):
        RecursionChain(srs.g2, srs.tau_g2).add_round(
            chain["voter"], Snark(chain["spk"].vk, chain["state1"].instances,
                                  bytes(bad)))


def test_srs_file_matches_jax(chain, tmp_path):
    """`save_srs` writes the JAX package's bytes (frozen sha256); `load_srs`
    reads them back to the same points and they pass both checks."""
    srs = chain["srs"]
    v = _vectors("srs_file_k7")
    path = str(tmp_path / "kzg_bn254_7.srs")
    save_srs(srs, path)
    with open(path, "rb") as f:
        data = f.read()
    assert len(data) == v["bytes"]
    assert hashlib.sha256(data).hexdigest() == v["sha256"]
    back = load_srs(path, device=DEV)
    assert back.k == 7 and (back.g2, back.tau_g2) == (srs.g2, srs.tau_g2)
    for a, b in ((back.g1, srs.g1), (back.g1_lagrange, srs.g1_lagrange)):
        for u, w in ((a.x, b.x), (a.y, b.y), (a.z, b.z)):
            assert torch.equal(u, w)
    assert srs_sanity_check(back) and _lagrange_sum_check(back)


@pytest.mark.parametrize("where", ["g1", "g1_lagrange", "g2", "truncated"])
def test_srs_loader_rejects_corruption(chain, tmp_path, where):
    path = str(tmp_path / "bad.srs")
    save_srs(chain["srs"], path)
    with open(path, "rb") as f:
        data = bytearray(f.read())
    n = 1 << 7
    if where == "truncated":
        data = data[:-1]
    else:
        off = {"g1": 4 + 64 + 3, "g1_lagrange": 4 + 64 * n + 64 * 5 + 40,
               "g2": 4 + 128 * n + 7}[where]
        data[off] ^= 1
    with open(path, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(ValueError):
        load_srs(path, device=DEV)


@pytest.fixture
def service():
    httpd = server.make_server(0, device=DEV)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=10)
    assert not t.is_alive()


def _post(url, path, obj):
    req = urllib.request.Request(url + path, json.dumps(obj).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=3600) as r:
        return json.loads(r.read())


def test_server_health_and_refusals(service):
    with urllib.request.urlopen(service + "/health", timeout=30) as r:
        out = json.loads(r.read())
    assert out == {"status": "ok", "circuits": ["voter", "state_transition"]}
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(service, "/prove", {"circuit": "nope"})
    assert ei.value.code == 400
    assert "error" in json.loads(ei.value.read())
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(service, "/nowhere", {"circuit": "voter"})
    assert ei.value.code == 404


def test_cli_arguments():
    ap = cli.parser()
    a = ap.parse_args(["keygen"])
    assert (a.circuit, a.k, a.seed, a.out, a.device, a.fn) == (
        "voter", 13, 0, "build", "cuda", cli.cmd_keygen)
    a = ap.parse_args(["prove", "--pk", "pk.bin", "--circuit",
                       "state_transition", "--k", "15", "--seed", "7",
                       "--device", "cpu"])
    assert (a.circuit, a.k, a.seed, a.pk, a.out, a.device, a.fn) == (
        "state_transition", 15, 7, "pk.bin", "build/proof.bin", "cpu",
        cli.cmd_prove)
    a = ap.parse_args(["verify", "--vk", "v", "--proof", "p",
                       "--instances", "i"])
    assert (a.vk, a.proof, a.instances, a.device) == ("v", "p", "i", "cuda")
    for argv in (["prove"], ["verify", "--vk", "v"], ["bench"], [],
                 ["keygen", "--circuit", "nope"]):
        with pytest.raises(SystemExit) as ei:
            ap.parse_args(argv)
        assert ei.value.code == 2
    with pytest.raises(ValueError, match="unknown circuit"):
        cli.build_circuit("nope", 13, 0)


def test_cli_verify_exit_codes(chain, tmp_path):
    """`verify` exits 0 on the voter proof and 1 on a flipped byte."""
    snark = chain["voter"]
    vk_path = str(tmp_path / "voter_vk.bin")
    save_vk(snark.vk, vk_path)
    with open(tmp_path / "voter.inst.json", "w") as f:
        json.dump(snark.instances, f)
    bad = bytearray(snark.proof)
    bad[len(bad) // 2] ^= 1
    for proof, code in ((snark.proof, 0), (bytes(bad), 1)):
        with open(tmp_path / "voter.proof", "wb") as f:
            f.write(proof)
        with pytest.raises(SystemExit) as ei:
            cli.main(["verify", "--vk", vk_path, "--proof",
                      str(tmp_path / "voter.proof"), "--instances",
                      str(tmp_path / "voter.inst.json"), "--device", DEV])
        assert ei.value.code == code


@pytest.mark.slow
def test_state_transition_k15_synthesis():
    """The state-transition circuit at the reference's k=15 (inputs of
    scripts/prove_state_tpu.py): stats, instances and layout shape equal
    the frozen JAX ones."""
    from zksnap_tpu_torch.circuits.state_transition import (
        expected_instances, state_transition_circuit)
    from zksnap_tpu_torch.natives import generate_wrapper_circuit_input
    from zksnap_tpu_torch.prover.keygen import (PERM_CHUNK, layout_circuit,
                                                quotient_ext_log)

    v = _vectors("state_k15")
    _, sts = generate_wrapper_circuit_input(1, random.Random(
        v["inputs_seed"]))
    ctx = Context(lookup_bits=v["lookup_bits"])
    pub = []
    state_transition_circuit(ctx, sts[0], pub)
    inst = [c.value for c in pub]
    assert inst == expected_instances(sts[0])
    check(ctx, inst)
    assert [str(x) for x in inst] == v["instances"]
    assert {k: int(x) for k, x in ctx.stats().items()
            if isinstance(x, int)} == v["stats"]
    lay = layout_circuit(ctx, v["k"])
    n_perm = len(lay.perm_columns)
    assert {"n_advice": lay.n_advice, "n_lookup": lay.n_lookup,
            "n_perm": n_perm, "n_z": -(-n_perm // PERM_CHUNK),
            "usable": lay.usable,
            "ext_log": quotient_ext_log(lay.n_lookup)} == v["vk_shape"]


@pytest.mark.slow
def test_cli_round_trip_state_transition(tmp_path):
    """keygen, prove and verify as subprocesses on the CPU at k=13 (the
    protocol's size; the plain path takes hours at k=15, which
    chip_smoke.py drives on the card): the vk digest and instances are
    the frozen JAX ones, verify exits 0, and 1 on a flipped byte."""
    import chip_smoke

    v = _vectors("state_k13")
    out = str(tmp_path)
    base = [sys.executable, "-m", "zksnap_tpu_torch.cli"]
    common = ["--circuit", "state_transition", "--k", str(v["k"]),
              "--seed", str(v["inputs_seed"]), "--device", DEV]

    def run(*args):
        return subprocess.run(base + list(args), cwd=ROOT, timeout=4 * 3600,
                              capture_output=True, text=True).returncode

    assert run("keygen", *common, "--out", out) == 0
    assert chip_smoke.vk_digest(load_vk(f"{out}/state_transition_vk.bin")) \
        == v["vk_sha256"]
    proof = f"{out}/st.proof"
    assert run("prove", *common, "--pk", f"{out}/state_transition_pk.bin",
               "--out", proof) == 0
    with open(proof + ".inst.json") as f:
        assert [str(x) for x in json.load(f)] == v["instances"]
    verify_args = ["verify", "--vk", f"{out}/state_transition_vk.bin",
                   "--proof", proof, "--instances", proof + ".inst.json",
                   "--device", DEV]
    assert run(*verify_args) == 0
    with open(proof, "rb") as f:
        bad = bytearray(f.read())
    bad[len(bad) // 2] ^= 1
    with open(proof, "wb") as f:
        f.write(bytes(bad))
    assert run(*verify_args) == 1


@pytest.mark.slow
def test_server_prove_verify_round_trip(service):
    """The voter at k=13 through the service on the CPU (minutes)."""
    out = _post(service, "/prove", {"circuit": "voter", "k": 13, "seed": 3})
    assert len(out["instances"]) == 30
    chk = _post(service, "/verify", {
        "circuit": "voter", "k": 13, "proof": out["proof"],
        "instances": out["instances"]})
    assert chk["valid"] is True
    bad = bytearray(bytes.fromhex(out["proof"]))
    bad[40] ^= 1
    chk = _post(service, "/verify", {
        "circuit": "voter", "k": 13, "proof": bytes(bad).hex(),
        "instances": out["instances"]})
    assert chk["valid"] is False
