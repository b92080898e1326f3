"""Tests for the server daemons.

usher_server (reference src/usher_server.cpp:28-486): argument-directory
polling daemon with pre-loaded MAT bookkeeping.
"""

import os

import pytest

from conftest import REFERENCE_TEST_DIR, REFERENCE_SCRIPTS_DIR

from usher_jax.cli.usher_cli import main as usher_main
from usher_jax.cli.usher_server_cli import MatStore, serve

SCRIPTS = REFERENCE_SCRIPTS_DIR

pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(SCRIPTS, "testBranchLen2.nwk")),
    reason="reference scripts unavailable")

NEW_SAMPLE_VCF = """##fileformat=VCFv4.2
#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tGT\tz1
x\t1\t.\tA\tT\t.\t.\t.\t.\t1
x\t2\t.\tA\tT\t.\t.\t.\t.\t1
x\t3\t.\tA\tT\t.\t.\t.\t.\t1
x\t6\t.\tA\tT\t.\t.\t.\t.\t1
x\t7\t.\tA\tT\t.\t.\t.\t.\t1
"""


@pytest.fixture(scope="module")
def small_mat(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("server_build"))
    pb = os.path.join(outdir, "small.pb")
    rc = usher_main(["-t", os.path.join(SCRIPTS, "testBranchLen2.nwk"),
                     "-v", os.path.join(SCRIPTS, "testBranchLen2.vcf"),
                     "-o", pb, "-d", outdir])
    assert rc == 0
    return pb


def test_usher_server_processes_request(small_mat, tmp_path):
    arg_dir = tmp_path / "args"
    arg_dir.mkdir()
    outdir = tmp_path / "req_out"
    vcf = tmp_path / "new.vcf"
    vcf.write_text(NEW_SAMPLE_VCF)

    req = (f"-i {small_mat} -v {vcf} -d {outdir} "
           f"-o {outdir}/result.pb^\n")
    (arg_dir / "job1.txt").write_text(req)

    store = MatStore("")
    rc = serve(str(arg_dir), store, sleep_ms=10, term_char=94, once=True)
    assert rc == 0
    # argument file consumed (usher_server.cpp:483)
    assert not list(arg_dir.iterdir())
    assert (outdir / "final-tree.nh").exists()
    assert (outdir / "result.pb").exists()
    stats = (outdir / "placement_stats.tsv").read_text()
    assert stats.startswith("z1\t")


def test_usher_server_skips_unterminated_file(small_mat, tmp_path):
    arg_dir = tmp_path / "args"
    arg_dir.mkdir()
    (arg_dir / "notready.txt").write_text("-i x -v y -d z\n")  # no '^'
    store = MatStore("")
    rc = serve(str(arg_dir), store, sleep_ms=10, term_char=94, once=True)
    assert rc == 0
    # unready file must be left in place
    assert (arg_dir / "notready.txt").exists()


def test_usher_server_mat_list_preload_and_consume(small_mat, tmp_path):
    mat_list = tmp_path / "mats.txt"
    mat_list.write_text(small_mat + "\n")
    store = MatStore(str(mat_list))
    assert store.load_list()
    assert store.trees[small_mat] is not None
    T = store.acquire(small_mat)
    assert T.root is not None
    # consumed: marked for reload
    assert store.trees[small_mat] is None
    store.refresh_consumed()
    assert store.trees[small_mat] is not None


def test_usher_server_version_and_reload_lines(small_mat, tmp_path, capsys):
    arg_dir = tmp_path / "args"
    arg_dir.mkdir()
    (arg_dir / "job.txt").write_text("--version^\n")
    store = MatStore("")
    rc = serve(str(arg_dir), store, sleep_ms=10, term_char=94, once=True)
    assert rc == 0
    assert "UShER" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# usher-sampled socket server (src/usher-sampled/driver/socket.cpp:100-661)
# ---------------------------------------------------------------------------

import socket  # noqa: E402
import threading  # noqa: E402

from usher_jax.cli.usher_socket_server_cli import (SocketServer,  # noqa: E402
                                                  TreeCollection,
                                                  handle_request)


def _request(sock_path: str, args: list[str]) -> bytes:
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.settimeout(60)
    c.connect(sock_path)
    c.sendall(("".join(a + "\n" for a in args) + "\n").encode())
    buf = b""
    while not buf.endswith(b"\x04\n"):
        chunk = c.recv(4096)
        if not chunk:
            break
        buf += chunk
    c.close()
    return buf


def test_socket_server_placement_roundtrip(small_mat, tmp_path):
    sock_path = str(tmp_path / "s.sock")
    fifo_path = str(tmp_path / "mgr.fifo")
    outdir = tmp_path / "sockout"
    vcf = tmp_path / "new.vcf"
    vcf.write_text(NEW_SAMPLE_VCF)

    trees = TreeCollection([small_mat])
    server = SocketServer(sock_path, fifo_path, trees, timeout_s=60)
    th = threading.Thread(target=server.serve_forever,
                          kwargs={"max_requests": 2}, daemon=True)
    th.start()
    try:
        # unknown tree -> "not found" reply listing loaded trees
        reply = _request(sock_path, ["-i", "/nonexistent.pb", "-v", str(vcf)])
        assert b"not found" in reply and small_mat.encode() in reply
        assert reply.endswith(b"\x04\n")

        reply = _request(sock_path, ["-i", small_mat, "-v", str(vcf),
                                     "-d", str(outdir)])
        assert reply.endswith(b"\x04\n")
        assert b"Sample name: z1" in reply
        assert (outdir / "final-tree.nh").exists()
        stats = (outdir / "placement_stats.tsv").read_text()
        assert stats.startswith("z1\t")
    finally:
        th.join(timeout=120)
        server.close()
    # preloaded tree must be unchanged by the placement (fork-isolation
    # semantics preserved by Tree.copy)
    assert trees.trees[small_mat].tree.get_node("z1") is None


def test_socket_server_existing_samples_mode(small_mat, tmp_path):
    outdir = tmp_path / "extract"
    outdir.mkdir()
    samples_file = tmp_path / "samples.txt"
    samples_file.write_text("a\nb\nnosuchsample\n")
    trees = TreeCollection([small_mat])
    reply = handle_request(
        ["-i", small_mat, "--existing_samples", str(samples_file),
         "-K", "4", "-d", str(outdir)], trees)
    assert reply.endswith(b"\x04\n")
    assert b"nosuchsample" in reply  # missing sample reported
    assert (outdir / "single-subtree.nh").exists()


def test_socket_server_fifo_stop(small_mat, tmp_path):
    sock_path = str(tmp_path / "s2.sock")
    fifo_path = str(tmp_path / "mgr2.fifo")
    trees = TreeCollection([])
    server = SocketServer(sock_path, fifo_path, trees, timeout_s=5)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    with open(fifo_path, "w") as f:
        f.write("stop\n")
        f.flush()
    th.join(timeout=30)
    assert not th.is_alive()
    assert not os.path.exists(sock_path)


def test_socket_server_fifo_reload_and_timeout(small_mat, tmp_path):
    """Manager fifo: reload (paths until blank line) + timeout N
    (socket.cpp:137-186)."""
    sock_path = str(tmp_path / "s3.sock")
    fifo_path = str(tmp_path / "mgr3.fifo")
    trees = TreeCollection([])
    assert trees.trees == {}
    server = SocketServer(sock_path, fifo_path, trees, timeout_s=30)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        with open(fifo_path, "w") as f:
            f.write(f"timeout 77\nreload\n{small_mat}\n\n")
            f.flush()
        # wait for the server loop to process
        import time
        for _ in range(100):
            if small_mat in trees.trees and server.timeout_s == 77:
                break
            time.sleep(0.1)
        assert server.timeout_s == 77
        assert small_mat in trees.trees
        # reloaded tree answers requests
        reply = _request(sock_path, ["-i", small_mat, "--existing_samples",
                                     "/dev/null", "-d", str(tmp_path)])
        assert reply.endswith(b"\x04\n")
    finally:
        with open(fifo_path, "w") as f:
            f.write("stop\n")
        th.join(timeout=30)
        server.close()


def test_usher_server_mat_list_serve_cycle(small_mat, tmp_path):
    """serve() with a MAT-list store: pre-loaded tree is used and re-loaded
    after consumption (usher_server.cpp:117-139)."""
    mat_list = tmp_path / "mats.txt"
    mat_list.write_text(small_mat + "\n")
    arg_dir = tmp_path / "args"
    arg_dir.mkdir()
    outdir = tmp_path / "out"
    vcf = tmp_path / "new.vcf"
    vcf.write_text(NEW_SAMPLE_VCF)
    (arg_dir / "j1.txt").write_text(
        f"-i {small_mat} -v {vcf} -d {outdir}^\n")
    store = MatStore(str(mat_list))
    assert store.load_list()
    rc = serve(str(arg_dir), store, sleep_ms=10, term_char=94, once=True)
    assert rc == 0
    assert (outdir / "placement_stats.tsv").exists()
    # consumed then available for reload on the next cycle
    store.refresh_consumed()
    assert store.trees[small_mat] is not None
    # the resident tree must NOT contain the placed sample (fresh reload)
    assert store.trees[small_mat].get_node("z1") is None
