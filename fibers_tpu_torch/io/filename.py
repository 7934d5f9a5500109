"""File-name resolution and temp-path discovery.

(reference: src/mri.jl:282-317, src/mri.jl:520-562)
"""

from __future__ import annotations

import os
import sys

__all__ = ["get_tmp_path", "mri_filename"]

_EXTLIST = ["mgh", "mgz", "nii", "nii.gz"]


def get_tmp_path(tmpdir: str = "") -> str:
    """Directory for temporary files: $TMPDIR, $TEMPDIR, /scratch, /tmp,
    `tmpdir`, else cwd.  (reference: src/mri.jl:282-317)"""
    for env in ("TMPDIR", "TEMPDIR"):
        p = os.environ.get(env)
        if p and os.path.isdir(p):
            return p
    for p in ("/scratch", "/tmp", tmpdir):
        if p and os.path.isdir(p):
            return p
    print("WARNING: get_tmp_path could not find a temporary folder, "
          "using current folder", file=sys.stderr)
    return "./"


def mri_filename(fstring: str, checkdisk: bool = True):
    """Resolve a file name or stem to (fname, fstem, fext).

    Valid extensions: mgh, mgz, nii, nii.gz.  If `fstring` has no extension
    and `checkdisk`, search disk for `fstring`.{mgh,mgz,nii,nii.gz}.
    Returns ("", "", "") when unresolvable.  (reference: src/mri.jl:520-562)
    """
    fname = fstem = fext = ""

    idot = fstring.rfind(".")

    if idot < 0 and checkdisk:
        for ext in _EXTLIST:
            name = fstring + "." + ext
            if os.path.isfile(name):
                fname, fstem, fext = name, fstring, ext
    else:
        ext = fstring[idot + 1:].lower() if idot >= 0 else ""
        if ext == "gz":
            idot2 = fstring.rfind(".", 0, idot)
            if idot2 >= 0:
                ext = fstring[idot2 + 1:].lower()
                idot = idot2
        if ext in _EXTLIST:
            fname = fstring
            fstem = fstring[:idot]
            fext = ext

    return fname, fstem, fext
