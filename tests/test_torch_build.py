"""The port's kernel builder (`repro_torch.kernels.build`) without a
compiler: a library that is already built is not rebuilt, and its
compiler report (ptxas's registers and spills, which `chip_smoke.py`
checks) is read back from beside it."""
from repro_torch.kernels import build


def test_compile_sources_reads_back_a_built_librarys_report(tmp_path,
                                                            monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)

    def no_nvcc():
        raise AssertionError("a built library was compiled again")

    monkeypatch.setattr(build, "nvcc_path", no_nvcc)
    lib = build.library_path("silu")
    assert lib.parent == tmp_path
    lib.write_bytes(b"")
    build._log_path(lib).write_text("ptxas info    : Used 30 registers")
    assert build.compile_sources(["silu"]) == {
        "silu": "ptxas info    : Used 30 registers"}
    build._log_path(lib).unlink()
    assert build.compile_sources(["silu"]) == {"silu": ""}
