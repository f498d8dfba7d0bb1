"""io/native.py builds the helper from the committed source, keyed on a
hash of that source, and reports once when it has to fall back."""

import hashlib
import shutil

from varlociraptor_tpu.io import native


def _fresh(monkeypatch, src, tmp_path):
    monkeypatch.setattr(native, "_NATIVE_DIR", tmp_path)
    monkeypatch.setattr(native, "_SRC", src)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)


def test_library_is_keyed_on_the_source_hash(monkeypatch, tmp_path, capsys):
    src = tmp_path / "vlt_native.cpp"
    shutil.copy(native._SRC, src)
    _fresh(monkeypatch, src, tmp_path)
    assert native.available()
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    assert [p.name for p in tmp_path.glob("*.so")] == [f"libvlt_native.{digest}.so"]
    assert capsys.readouterr().err == ""


def test_fallback_is_reported_once(monkeypatch, tmp_path, capsys):
    src = tmp_path / "vlt_native.cpp"
    src.write_text("this is not C++\n")
    _fresh(monkeypatch, src, tmp_path)
    assert not native.available()
    assert not native.available()
    err = capsys.readouterr().err
    assert err.count("falling back to pure Python") == 1
    assert not list(tmp_path.glob("*.so"))
