"""`python -m fibers_tpu_torch` against `python -m fibers_tpu`: the cases
of tests/test_cli.py on the port, each output file held against the file
the JAX package's CLI writes from the same inputs.

Tolerances as the library tests: FA atol=1e-4 (test_torch_dti.py), GQI
QA atol=1e-5 (test_torch_gqi.py), DSI QA atol=1e-5 (test_torch_dsi.py),
structure-tensor eigenvalues within 1e-5 of the largest
(test_torch_structens.py), tracts as test_torch_stream.py.
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import pytest

import fibers_tpu as ft
from fibers_tpu.__main__ import main as jmain
from fibers_tpu_torch.__main__ import CMDS
from fibers_tpu_torch.__main__ import main as port_main

from phantom import make_phantom
from test_torch_stream import _compare_tracts

def main(argv):
    """The port's CLI on the CPU: its default device is the card."""
    return port_main(["--device", "cpu", *argv])


SUBCOMMANDS = ("info", "disp", "adc", "dti", "gqi", "dsi", "rumba",
               "structens", "stream", "pipeline")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    dwi, mask, _, _ = make_phantom(shape=(8, 8, 8), ndir=30)
    dp = str(tmp / "dwi.nii.gz")
    mp = str(tmp / "mask.nii.gz")
    ft.mri_write(dwi, dp)
    ft.mri_write(mask, mp)
    return tmp, dp, mp


def _vol(path):
    return np.squeeze(np.asarray(ft.mri_read(path).vol))


def test_every_subcommand_dispatches_to_the_port():
    """Each subcommand runs this package's command, never the reference
    parser's own `fn` default."""
    assert tuple(CMDS) == SUBCOMMANDS
    for fn in CMDS.values():
        assert fn.__module__ == "fibers_tpu_torch.__main__"


def _parser_shape(parser):
    """Every argument of a parser and of each subcommand's parser: dest,
    option strings, default, nargs, choices, required, type and action,
    and the subcommand's defaults other than its `fn`."""
    def args(p):
        return [(a.dest, tuple(a.option_strings), a.default, a.nargs,
                 None if a.choices is None else tuple(a.choices),
                 a.required, getattr(a.type, "__name__", None),
                 type(a).__name__)
                for a in p._actions
                if not isinstance(a, (argparse._HelpAction,
                                      argparse._SubParsersAction))]

    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    shape = {"": args(parser)}
    for name, p in sub.choices.items():
        shape[name] = args(p) + [sorted(
            (k, v) for k, v in p._defaults.items() if k != "fn")]
    return shape


def test_parser_is_the_references_plus_device():
    """The port's copy of `build_parser` has the reference's subcommands,
    positionals, options and defaults, and one more top-level option:
    `--device {cuda,cpu}`, default cuda."""
    from fibers_tpu.__main__ import build_parser as jparser
    from fibers_tpu_torch.__main__ import build_parser

    got, want = _parser_shape(build_parser()), _parser_shape(jparser())
    assert list(got) == list(want) == ["", *SUBCOMMANDS]
    assert got[""] == want[""] + [("device", ("--device",), "cuda", None,
                                   ("cuda", "cpu"), False, None,
                                   "_StoreAction")]
    for name in SUBCOMMANDS:
        assert got[name] == want[name], name
    for name, fn in build_parser()._subparsers._group_actions[0] \
            .choices.items():
        assert fn._defaults["fn"] is CMDS[name]


def test_help_lists_the_subcommands():
    proc = subprocess.run([sys.executable, "-m", "fibers_tpu_torch",
                           "--help"], capture_output=True, text=True,
                          cwd=os.path.join(os.path.dirname(__file__), ".."),
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "python -m fibers_tpu_torch" in proc.stdout
    for name in SUBCOMMANDS:
        assert name in proc.stdout


def test_info_headeronly_and_full(data, capsys):
    _, dp, _ = data
    assert main(["info", dp]) == 0
    out = capsys.readouterr().out
    assert "Volume dimensions: [8, 8, 8, 31]" in out
    assert "b-values" in out
    assert "Intensity range" not in out
    assert main(["info", dp, "--full"]) == 0
    assert "Intensity range" in capsys.readouterr().out


def test_dti_matches_jax_cli(data):
    tmp, dp, mp = data
    assert main(["dti", dp, mp, str(tmp / "t_dti")]) == 0
    assert jmain(["dti", dp, mp, str(tmp / "j_dti")]) == 0
    got, want = _vol(str(tmp / "t_dti_fa.nii.gz")), _vol(
        str(tmp / "j_dti_fa.nii.gz"))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_gqi_then_stream_from_struct(data):
    tmp, dp, mp = data
    for run, tag in ((main, "t"), (jmain, "j")):
        base = str(tmp / f"{tag}_gqi")
        assert run(["gqi", dp, mp, base]) == 0
        assert run(["stream", base, "GQI", "--mask", mp, "-o",
                    str(tmp / f"{tag}.trk"), "--f-thresh", "0.0",
                    "--wire", "f32"]) == 0
    np.testing.assert_allclose(_vol(str(tmp / "t_gqi_qa1.nii.gz")),
                               _vol(str(tmp / "j_gqi_qa1.nii.gz")),
                               atol=1e-5, rtol=0)
    tj, tr = ft.trk_read(str(tmp / "j.trk")), ft.trk_read(str(tmp / "t.trk"))
    assert tr.n_count > 0
    _compare_tracts(tj, tr)


def test_rumba_with_checkpoint(data):
    tmp, dp, mp = data
    base = str(tmp / "rumba")
    ck = str(tmp / "r.ckpt.npz")
    assert main(["rumba", dp, mp, base, "--niter", "4",
                 "--checkpoint", ck, "--checkpoint-every", "2"]) == 0
    assert os.path.isfile(base + "_gfa.nii.gz")
    assert os.path.isfile(ck)


def test_adc_and_structens_match_jax_cli(data):
    tmp, dp, mp = data
    assert main(["adc", dp, mp, str(tmp / "a")]) == 0
    assert os.path.isfile(str(tmp / "a_adc.nii.gz"))
    s0 = str(tmp / "a_s0.nii.gz")
    for run, tag in ((main, "t"), (jmain, "j")):
        assert run(["structens", s0, str(tmp / f"{tag}_st"), "--sigma",
                    "1.0", "--rho", "1.0"]) == 0
    got = _vol(str(tmp / "t_st_eigval.nii.gz"))
    want = _vol(str(tmp / "j_st_eigval.nii.gz"))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert _vol(str(tmp / "t_st_eigvec.nii.gz")).shape == (8, 8, 8, 9)


def test_dsi_matches_jax_cli(tmp_path):
    from test_dsi import make_dsi_phantom

    dwi, mask, _ = make_dsi_phantom(shape=(4, 4, 4))
    dp, mp = str(tmp_path / "q.nii.gz"), str(tmp_path / "m.nii.gz")
    ft.mri_write(dwi, dp)
    ft.mri_write(mask, mp)
    # the default --wire auto8 uploads exact float32
    assert main(["dsi", dp, mp, str(tmp_path / "t_dsi")]) == 0
    assert jmain(["dsi", dp, mp, str(tmp_path / "j_dsi")]) == 0
    got = _vol(str(tmp_path / "t_dsi_qa1.nii.gz"))
    assert np.isfinite(got).all() and (got > 0).all()
    np.testing.assert_allclose(got, _vol(str(tmp_path / "j_dsi_qa1.nii.gz")),
                               atol=1e-5, rtol=0)


def test_pipeline(data):
    tmp, dp, mp = data
    outdir = str(tmp / "pipe")
    assert main(["pipeline", dp, mp, outdir]) == 0
    assert ft.trk_read(os.path.join(outdir, "tracts.trk")).n_count > 0
    assert os.path.isfile(os.path.join(outdir, "dti_fa.nii.gz"))
    assert os.path.isfile(os.path.join(outdir, "gqi_qa1.nii.gz"))


@pytest.mark.parametrize("cmd", ["pipeline", "dti", "structens"])
def test_mesh_raises_naming_a13(data, cmd):
    """tests/test_cli.py's sharded pipeline: multi-device runs are not
    ported, so `--mesh 2` raises naming ROADMAP A13."""
    tmp, dp, mp = data
    argv = {"pipeline": ["pipeline", dp, mp, str(tmp / "p8")],
            "dti": ["dti", dp, mp, str(tmp / "d8")],
            "structens": ["structens", mp, str(tmp / "s8")]}[cmd]
    with pytest.raises(NotImplementedError, match="A13"):
        main(argv + ["--mesh", "2"])


def test_unknown_sphere_and_struct_rejected(data):
    tmp, dp, mp = data
    with pytest.raises(SystemExit):
        main(["gqi", dp, mp, str(tmp / "x"), "--sphere", "999"])
    with pytest.raises(SystemExit):
        main(["stream", str(tmp / "x"), "ODF", "-o", str(tmp / "x.trk")])
