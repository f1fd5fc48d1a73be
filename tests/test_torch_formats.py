"""The host ingest formats of the PyTorch port (``io/formats.py`` behind
``import_file``: SVMLight, ARFF, XLSX and Avro) on the CPU, held against
the reference package on the same files.

The cases are the reference's own (tests/test_parity_extras.py:
SVMLight, ARFF, quoted ARFF, XLSX, the ``.xls`` gate;
tests/test_formats_columnar.py: Avro with both codecs) and the files
``chip_smoke.py`` phase 28(a) writes (its writers, on airlines rows
made from a seed), plus NA, error and glob cases. Each port frame equals
the reference's: names, types, domains, codes, NA masks and the float64
host and float32 numeric views bit for bit. The airlines files also
equal the same rows read from CSV by the port (SVMLight on its numeric
encoding)."""

import sys
from pathlib import Path

import numpy as np
import pytest

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.io import formats as ref_formats

from test_torch_ingest import _assert_frames
from test_torch_isofor import _one_device
from test_formats_columnar import _write_avro
from torch_threads import one_torch_thread  # noqa: F401 - autouse

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def _both(path):
    """(reference frame, port frame) of ``import_file(path)``, equal."""
    with _one_device():
        ref = h2o3_tpu.import_file(str(path))
    port = h2o3_tpu_torch.import_file(str(path), device="cpu")
    _assert_frames(ref, port)
    return ref, port


def _both_raise(path, exc, match=None):
    with _one_device():
        with pytest.raises(exc, match=match):
            h2o3_tpu.import_file(str(path))
    with pytest.raises(exc, match=match):
        h2o3_tpu_torch.import_file(str(path), device="cpu")


def test_svmlight_parse(tmp_path):
    p = tmp_path / "t.svm"
    p.write_text("1 1:0.5 3:2.0\n-1 2:1.5 # comment\n1 qid:7 1:1.0 4:4.0\n")
    _, fr = _both(p)
    assert (fr.nrows, fr.ncols) == (3, 5)   # C0 label + C1..C4
    np.testing.assert_array_equal(fr.col("C0").to_numpy(), [1, -1, 1])
    np.testing.assert_array_equal(fr.col("C3").to_numpy(), [2.0, 0.0, 0.0])
    np.testing.assert_array_equal(fr.col("C4").to_numpy(), [0.0, 0.0, 4.0])


def test_svmlight_repeats_blanks_tabs_and_glob(tmp_path):
    r = np.random.RandomState(4)
    lines = []
    for i in range(300):
        idx = r.choice(40, r.randint(0, 6), replace=False) + 1
        toks = [f"{j}:{r.randn():.9g}" for j in idx]
        if i % 17 == 0 and toks:
            toks.append(f"{idx[0]}:{r.randn()!r}")     # repeated: last wins
        if i % 23 == 0:
            toks.insert(0, f"qid:{i}")
        sep = "\t" if i % 5 == 0 else " "
        lines.append(sep.join([f"{r.randint(0, 3)}"] + toks))
        if i % 31 == 0:
            lines.append("   # a comment line")
    (tmp_path / "d").mkdir()
    (tmp_path / "d" / "a.svm").write_text("\n".join(lines[:150]) + "\n")
    (tmp_path / "d" / "b.svmlight").write_text("\n".join(lines[150:]))
    _both(tmp_path / "d")
    _both(tmp_path / "d" / "*")


@pytest.mark.parametrize("text", ["1 0:2\n", "1 3:\n", "1 :4\n",
                                  "1 3:4:5\n", "1 4\n"])
def test_svmlight_bad_tokens_raise(tmp_path, text):
    p = tmp_path / "bad.svm"
    p.write_text(text)
    _both_raise(p, ValueError)


ARFF = """% comment
@relation demo
@attribute sepal numeric
@attribute color {red, green, blue}
@attribute note string
@data
5.1,red,'hello'
4.9,blue,?
?,green,world
"""


def test_arff_parse(tmp_path):
    p = tmp_path / "t.arff"
    p.write_text(ARFF)
    _, fr = _both(p)
    assert (fr.nrows, fr.ncols) == (3, 3)
    assert fr.col("color").domain == ["red", "green", "blue"]
    x = fr.col("sepal").to_numpy()
    assert np.isnan(x[2]) and x[0] == pytest.approx(5.1)
    assert fr.col("note").type == "string"


def test_arff_quoted_names_and_values(tmp_path):
    p = tmp_path / "q.arff"
    p.write_text("""@relation q
@attribute 'sepal length' numeric
@attribute label {x, y}
@attribute note string
@data
5.1,x,'a, b'
4.2,y,plain
""")
    _, fr = _both(p)
    assert "sepal length" in fr.names
    assert fr.col("sepal length").to_numpy()[0] == pytest.approx(5.1)
    assert fr.col("note").to_numpy()[0] == "a, b"


def test_arff_short_rows_unseen_levels_and_blanks(tmp_path):
    p = tmp_path / "s.arff"
    p.write_text(ARFF.replace("@data\n", "@attribute when date\n@data\n")
                 + "3.5, purple ,'x'\n% interleaved comment\n\n"
                 + "7\n2.25,blue,'q,r',2020-01-01\n")
    _both(p)
    p.write_text("@relation r\n@attribute a numeric\n")
    _both_raise(p, ValueError, "no @data")


def _xlsx(path, sheet, shared=None):
    import zipfile
    ns = "http://schemas.openxmlformats.org/spreadsheetml/2006/main"
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("[Content_Types].xml", "<Types/>")
        if shared is not None:
            z.writestr("xl/sharedStrings.xml", (
                f'<?xml version="1.0"?><sst xmlns="{ns}">' + "".join(
                    f"<si><t>{s}</t></si>" for s in shared) + "</sst>"))
        z.writestr("xl/worksheets/sheet1.xml", (
            f'<?xml version="1.0"?><worksheet xmlns="{ns}"><sheetData>'
            f"{sheet}</sheetData></worksheet>"))


def test_xlsx_parse(tmp_path):
    """The reference's case: header row, shared strings, inline strings,
    a missing cell as NA, the text column a categorical."""
    p = tmp_path / "t.xlsx"
    _xlsx(p, '<row r="1"><c r="A1" t="s"><v>0</v></c>'
             '<c r="B1" t="s"><v>1</v></c></row>'
             '<row r="2"><c r="A2"><v>31.5</v></c>'
             '<c r="B2" t="s"><v>2</v></c></row>'
             '<row r="3"><c r="A3"><v>44</v></c>'
             '<c r="B3" t="s"><v>3</v></c></row>'
             '<row r="4"><c r="B4" t="inlineStr"><is><t>sf</t></is></c>'
             '</row>', ["age", "city", "sf", "nyc"])
    _, fr = _both(p)
    assert fr.names == ["age", "city"] and fr.nrows == 3
    age = fr.col("age").to_numpy()
    assert age[0] == 31.5 and age[1] == 44 and np.isnan(age[2])
    c = fr.col("city")
    assert c.is_categorical
    assert [c.domain[i] for i in c.data.numpy()[:3]] == ["sf", "nyc", "sf"]


def test_xlsx_headerless_bools_gaps_and_trailing_rows(tmp_path):
    p = tmp_path / "h.xlsx"
    _xlsx(p, '<row><c><v>1</v></c><c t="b"><v>1</v></c>'
             '<c t="str"><v>a</v></c></row>'
             '<row></row>'
             '<row><c r="C3" t="inlineStr"><is><t>b</t><t>c</t></is></c>'
             '<c r="A3"><v>2.5</v></c></row>'
             '<row><c r="A4"><v>-3</v></c><c r="B4" t="b"><v>0</v></c></row>'
             '<row r="9"></row><row r="10"/>')
    _both(p)
    _xlsx(p, '<row r="1"/>')
    _both_raise(p, ValueError, "empty worksheet")


def test_xls_gated(tmp_path):
    p = tmp_path / "legacy.xls"
    p.write_bytes(b"\xd0\xcf\x11\xe0junk")
    _both_raise(p, ValueError, "xlsx")


@pytest.mark.parametrize("codec", ["null", "deflate"])
def test_avro(tmp_path, codec):
    p = tmp_path / "t.avro"
    rows = _write_avro(str(p), codec)
    _, fr = _both(p)
    assert fr.nrows == len(rows)
    b = fr.col("b").to_numpy()
    assert b[0] == 7 and np.isnan(b[1]) and b[2] == 42
    s = fr.col("s")
    assert s.is_categorical and s.domain == ["x", "y"]


def test_avro_bad_files_raise(tmp_path):
    p = tmp_path / "x.avro"
    p.write_bytes(b"not avro at all")
    _both_raise(p, ValueError, "not an avro container")
    cs_cols = {"a": np.arange(5)}
    data = bytearray(cs.avro_bytes(cs_cols, {}, codec="null"))
    data[-1] ^= 0xFF                              # the last sync marker
    p.write_bytes(bytes(data))
    _both_raise(p, ValueError, "sync marker")


def _airlines(n=3000, seed=7):
    """airlines rows with the categoricals' codes in their sorted
    domains (what a parse interns)."""
    cols, domains = cs.airlines_arrays(n, seed)
    return cs.sorted_codes(cols, domains)


def test_airlines_files_equal_the_reference_and_the_csv_path(tmp_path):
    """chip_smoke phase 28(a) at a small size: each writer's file read by
    both packages gives one frame, and it equals the port's CSV frame
    of the same rows (SVMLight on its numeric encoding)."""
    cols, doms = _airlines()
    head = {k: v[:1000] for k, v in cols.items()}
    files = {"csv": cs.csv_bytes(cols, doms),
             "head.csv": cs.csv_bytes(head, doms),
             "svm": cs.svmlight_bytes(cols, cs.Y),
             "arff": cs.arff_bytes(cols, doms),
             "avro": cs.avro_bytes(cols, doms, block_rows=700),
             "xlsx": cs.xlsx_bytes(head, doms)}
    port = {}
    for kind, data in files.items():
        p = tmp_path / f"air.{kind}"
        p.write_bytes(data)
        if kind.endswith("csv"):
            port[kind] = h2o3_tpu_torch.import_file(str(p), device="cpu")
        else:
            port[kind] = _both(p)[1]
    assert cs.same_frames(port["arff"], port["csv"])
    assert cs.same_frames(port["avro"], port["csv"])
    assert cs.same_frames(port["xlsx"], port["head.csv"])
    svm, csv = port["svm"], port["csv"]
    x = [c for c in csv.names if c != cs.Y]
    for a, b in zip(svm.names, [cs.Y] + x):
        np.testing.assert_array_equal(svm.col(a).host_view(),
                                      csv.col(b).host_view())


def test_avro_writer_floats_and_nas(tmp_path):
    """Float columns, NaN and NA codes as ``null`` unions, many blocks:
    both packages read the same frame, with the written values."""
    r = np.random.RandomState(5)
    n = 2500
    f = r.randn(n)
    f[::7] = np.nan
    g = r.randint(-1, 3, n)                       # -1: NA
    cols = {"i": r.randint(0, 10 ** 12, n), "f": f, "g": g,
            "h": r.randint(0, 2, n)}
    doms = {"g": ["lo", "mid", "hi"], "h": ["no", "yes"]}
    for codec in ("null", "deflate"):
        p = tmp_path / f"w_{codec}.avro"
        p.write_bytes(cs.avro_bytes(cols, doms, codec=codec, block_rows=333))
        _, fr = _both(p)
        np.testing.assert_array_equal(fr.col("i").host_view(),
                                      cols["i"].astype(float))
        np.testing.assert_array_equal(fr.col("f").host_view(), f)
        labels = np.array(sorted(doms["g"]), object)
        got = fr.col("g")
        want = np.where(g >= 0, np.array(doms["g"], object)[g], None)
        dec = np.where(np.isnan(got.host_view()), None,
                       labels[np.nan_to_num(got.host_view()).astype(int)])
        assert list(dec) == list(want)


def test_avro_reader_primitives_match_the_reference():
    """Each schema type decodes the same value from the same bytes in
    both packages (unions, enums, arrays, floats, bytes)."""
    from h2o3_tpu_torch.io import formats
    cases = [
        ("long", b"\x80\x01"), ("int", b"\x7f"), ("boolean", b"\x01"),
        ("float", np.float32(1.5).tobytes()),
        ("double", np.float64(-2.25).tobytes()),
        ("string", b"\x06abc"), ("bytes", b"\x04\x00\xff"),
        (["null", "long"], b"\x00"), (["null", "long"], b"\x02\x0a"),
        ({"type": "enum", "symbols": ["A", "B", "C"]}, b"\x04"),
        ({"type": "array", "items": "long"}, b"\x04\x02\x04\x00"),
        ({"type": "array", "items": "long"}, b"\x03\x04\x02\x04\x00"),
        ({"type": "record", "name": "q", "fields": [
            {"name": "a", "type": "long"}, {"name": "b",
                                            "type": "string"}]},
         b"\x08\x02z")]
    for schema, buf in cases:
        assert formats._avro_read(buf, 0, schema) == \
            ref_formats._avro_read(buf, 0, schema), schema
    for v in (0, 1, -1, 63, -64, 64, 2 ** 31, -(2 ** 40) - 3):
        b, k = cs.varint_bytes(np.array([v]))
        raw = b[0][k[0]].tobytes()
        assert formats._avro_varint(raw, 0) == \
            ref_formats._avro_varint(raw, 0) == (v, len(raw))
