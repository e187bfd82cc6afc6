"""Summarize Boussinesq_study results into an iteration-count table.

The reference study's de-facto benchmark is the saved
``[cd_linear_solves, ns_linear_solves, nonlinear_iters]`` triple per
configuration (reference study/Boussinesq_run.py:114-135); this prints a
markdown table of every saved run for reports.

Durability: the full-field ``.npz`` artifacts are ~20 MB each and gitignored
(they do not survive workspace resets).  For every ``.npz`` processed, this
script (re)writes a compact ``<title>.stats.json`` sidecar — iteration
counts + literature anchors + config — which IS committed; runs whose
``.npz`` has since been cleaned still appear in the table from their
sidecar.  Workflow: sweep → ``python study/summarize.py`` → commit the
refreshed ``Boussinesq_study/*.stats.json``.

Usage: python study/summarize.py [dir]
"""
import re
import sys
import glob
import json
import os

import numpy as np


def parse_title(name):
    """(mode, Re, Ra, Pr, P, Ne) from a study run title, or None."""
    m = re.match(r"Boussinesq(GS|NJ|JNK|PTC)_([0-9.e+~-]+)_(\d+)~(\d+)_",
                 name)
    if not m:
        return None
    mode, phys, P, Ne = m.group(1), m.group(2), m.group(3), m.group(4)
    Re, Ra, Pr = phys.split("~")
    return mode, float(Re), float(Ra), float(Pr), int(P), int(Ne)


def row_from_npz(f):
    """Full-accuracy row from a field .npz; refreshes its .stats.json."""
    name = os.path.basename(f)[:-4]
    cfg = parse_title(name)
    if cfg is None:
        return None
    mode, Re, Ra, Pr, P, Ne = cfg
    with np.load(f) as z:
        arrs = [z[k] for k in z.files]
    iters = next(a for a in arrs if a.ndim == 1 and a.size in (3, 4))
    u_e, v_e = arrs[1], arrs[2]
    if Ra > 1.1e4:
        # the domain u-max exceeds the centerline u-max at high Ra
        # (the peak moves off x=L/2) — report the literature-comparable
        # centerline anchor instead (de Vahl Davis / Le Quere tables)
        from centerline import centerline_anchors
        u_anchor, v_anchor = centerline_anchors(u_e, v_e, P, Ne,
                                                Re=Re, Pr=Pr)
        kind = "centerline"
    else:
        u_anchor = float(np.abs(u_e).max()) * Re * Pr
        v_anchor = float(np.abs(v_e).max()) * Re * Pr
        kind = "domain_max"
    stats = dict(mode=mode, Re=Re, Ra=Ra, Pr=Pr, P=P, Ne=Ne,
                 iters=[int(x) for x in iters],
                 u_anchor=round(u_anchor, 4), v_anchor=round(v_anchor, 4),
                 anchor_kind=kind)
    with open(f[:-4] + ".stats.json", "w") as fh:
        json.dump(stats, fh, indent=1)
    return stats


def main(d="Boussinesq_study"):
    stats_by_title = {}
    # sidecars first (the durable record) ...
    for f in sorted(glob.glob(os.path.join(d, "*.stats.json"))):
        title = os.path.basename(f)[: -len(".stats.json")]
        try:
            with open(f) as fh:
                stats_by_title[title] = json.load(fh)
        except (OSError, ValueError):
            continue
    # ... then any live .npz overrides/refreshes its sidecar
    for f in sorted(glob.glob(os.path.join(d, "*.npz"))):
        if f.endswith(".ckpt.npz"):  # mid-solve checkpoint, not a result
            continue
        s = row_from_npz(f)
        if s is not None:
            stats_by_title[os.path.basename(f)[:-4]] = s
    rows = sorted(stats_by_title.values(),
                  key=lambda s: (s["Re"], s["Ra"], s["P"], s["Ne"],
                                 s["mode"]))
    print("| mode | Re | Ra | P | Ne | [cd, ns, nonlinear] | u_max·Re·Pr |")
    print("|---|---|---|---|---|---|---|")
    for s in rows:
        tag = "*" if s.get("anchor_kind") == "centerline" else ""
        print(f"| {s['mode']} | {s['Re']:.0e} | {s['Ra']:.0e} | {s['P']} "
              f"| {s['Ne']} | {s['iters']} | {s['u_anchor']}{tag} |")


if __name__ == "__main__":
    main(*sys.argv[1:])
