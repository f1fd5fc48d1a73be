"""The port's h2o-r generator (``h2o3_tpu_torch.client_r``) and R syntax
check (``client_r.rcheck``), held against the reference's.

The R package is generated from each server's live ``/3/ModelBuilders``
(the reference's server, and the port's on the CPU) by each package's
own generator. Every file the reference writes is written by the port
byte for byte. The port's package has one file more,
``R/stackedensemble.R``, and the matching ``export(h2o.stackedensemble)``
line in NAMESPACE: the port's registry serves StackedEnsemble, which the
reference trains outside its own. Every file of both packages passes the
port's ``rcheck``, which judges the reference's validator's cases alike.
"""

import json
import os
import urllib.request

import pytest

from h2o3_tpu.api import server as ref_server
from h2o3_tpu.client_r import generate_from_live as ref_generate
from h2o3_tpu.client_r.rcheck import check_r_source as ref_check
from h2o3_tpu_torch.api import server as port_server
from h2o3_tpu_torch.client_r import generate_from_live, generate_r_package
from h2o3_tpu_torch.client_r.rcheck import check_r_source

from torch_threads import one_torch_thread  # noqa: F401 - autouse

EXTRA_FILE = os.path.join("R", "stackedensemble.R")


@pytest.fixture(scope="module")
def urls():
    rp = ref_server.start_server(port=0, background=True)
    pp = port_server.start_server(port=0, background=True, device="cpu")
    yield f"http://127.0.0.1:{rp}", f"http://127.0.0.1:{pp}"
    ref_server.stop_server()
    port_server.stop_server()


def _files(root, written):
    return {os.path.relpath(p, root): open(p).read() for p in written}


def test_generated_package_equals_the_reference(urls, tmp_path):
    ref = _files(tmp_path / "r", ref_generate(str(tmp_path / "r"), urls[0]))
    port = _files(tmp_path / "p", generate_from_live(str(tmp_path / "p"),
                                                     urls[1]))
    assert set(port) == set(ref) | {EXTRA_FILE}
    for rel, src in ref.items():
        if rel == "NAMESPACE":
            lines = port[rel].splitlines()
            lines.remove("export(h2o.stackedensemble)")
            assert lines == src.splitlines()
        else:
            assert port[rel] == src, rel
    for rel, src in port.items():
        if rel.endswith(".R"):
            assert not check_r_source(src), rel


def test_package_from_the_builders_payload(urls, tmp_path):
    """``generate_r_package`` over the port server's payload writes what
    ``generate_from_live`` writes."""
    meta = json.loads(urllib.request.urlopen(
        f"{urls[1]}/3/ModelBuilders").read())["model_builders"]
    a = _files(tmp_path / "a", generate_r_package(str(tmp_path / "a"),
                                                  meta))
    b = _files(tmp_path / "b", generate_from_live(str(tmp_path / "b"),
                                                  urls[1]))
    assert a == b
    assert "ntrees = 50" in a[os.path.join("R", "gbm.R")]


@pytest.mark.parametrize("src", [
    'f <- function(x { x }', 'x <- "unterminated', 'y <- 1 +',
    'h2o.init <- function(url = "http://x") {\n'
    '  resp <- .h2o.get(url, "/3/Cloud")\n'
    '  invisible(resp$cloud_name)\n}\n',
    "a <- c(1, 2]\n", "# only a comment\n", "g <- function() {\n"])
def test_rcheck_judges_as_the_reference(src):
    assert check_r_source(src) == ref_check(src)
