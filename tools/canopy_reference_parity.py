#!/usr/bin/env python3
"""Run the REFERENCE's own canopy algorithm (cv2 GrabCut pipeline) on the
four checked-in captures and compare against (a) the checked-in
canopy_y_*.txt truths and (b) the repo's on-device pipeline output.

Purpose (VERDICT r3 missing #1 / next #2): the repo's golden gate was
re-grounded in r3 to a tip-physics truth on the claim that the three
truths -0.0411/-0.0421/-0.0476 are GrabCut thin-tip dropout artifacts.
cv2 5.0 IS installed, so instead of arguing, run the reference ALGORITHM
(canopy_return.py:319-409 / canopy_return_upgraded.py:97-151: bar-edge
rotate -> green-seeded GrabCut -> strict green mask -> highest plant
pixel -> 5x5 median depth -> deproject, writing canopy_3d Y) directly on
the captures and measure what it actually produces — including its
sensitivity to the GrabCut GMM's kmeans RNG seed.

This file REIMPLEMENTS the reference steps faithfully (same cv2 calls,
same constants); it is analysis tooling, not part of the repas_tpu
package (the package's own canopy path is cv2-free, canopy/segment.py).
"""
from __future__ import annotations

import json
import math
import os
import sys

import cv2
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BASE = "/root/reference/realsense_d415i/canopy_detection/new-captures"
STAMPS = ["2025-11-14T143013", "2025-11-14T143028",
          "2025-11-14T143037", "2025-11-14T143042"]
# same stand-in intrinsics the repo golden test uses (the session's exact
# factory intrinsics are not checked in; fx~910 at 720p per
# three_pose_vertical_translation_validation.py:29-33)
FX, FY, CX, CY = 912.35, 911.78, 628.78, 348.98


def rotate_info(bgr):
    """canopy_return.py detect_rotate_aluminum_bar_edges semantics."""
    gray = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
    blurred = cv2.GaussianBlur(gray, (5, 5), 0)
    edges = cv2.Canny(blurred, 50, 150)
    lines = cv2.HoughLinesP(edges, rho=1, theta=np.pi / 180, threshold=50,
                            minLineLength=50, maxLineGap=10)
    if lines is None:
        return None, bgr
    for line in lines:
        x1, y1, x2, y2 = np.ravel(line)[:4]   # cv2 5.0: (N,4); 4.x: (N,1,4)
        length = math.hypot(x2 - x1, y2 - y1)
        ang = math.degrees(math.atan2(y2 - y1, x2 - x1))
        if length > bgr.shape[1] * 0.1 and (abs(ang) < 20 or abs(ang) > 160):
            h, w = bgr.shape[:2]
            M = cv2.getRotationMatrix2D((w // 2, h // 2), ang, 1.0)
            rot = cv2.warpAffine(bgr, M, (w, h), flags=cv2.INTER_LINEAR,
                                 borderMode=cv2.BORDER_CONSTANT,
                                 borderValue=(255, 255, 255))
            return M, rot
    return None, bgr


def reference_canopy(bgr, depth_mm, seed):
    """GrabCut pipeline -> (canopy_y_3d, row_rotated, orig_xy, depth_m)."""
    cv2.setRNGSeed(seed)
    M, rot = rotate_info(bgr)

    hsv = cv2.cvtColor(rot, cv2.COLOR_BGR2HSV)
    green = cv2.inRange(hsv, (35, 40, 40), (85, 255, 255))
    gmask = np.where(green == 255, cv2.GC_PR_FGD, cv2.GC_BGD).astype("uint8")
    bgd = np.zeros((1, 65), np.float64)
    fgd = np.zeros((1, 65), np.float64)
    h, w = rot.shape[:2]
    cv2.grabCut(rot, gmask, (1, 1, w - 2, h - 2), bgd, fgd, 5,
                cv2.GC_INIT_WITH_MASK)
    fg = ((gmask == cv2.GC_FGD) | (gmask == cv2.GC_PR_FGD)).astype("uint8")
    plant = rot * fg[:, :, None]

    hsv2 = cv2.cvtColor(plant, cv2.COLOR_BGR2HSV)
    strict = cv2.inRange(hsv2, (35, 80, 30), (85, 255, 255))
    k = np.ones((3, 3), np.uint8)
    strict = cv2.morphologyEx(strict, cv2.MORPH_OPEN, k)
    strict = cv2.morphologyEx(strict, cv2.MORPH_CLOSE, k)
    colored = cv2.bitwise_and(plant, plant, mask=strict)

    mask = np.any(colored != 0, axis=2)
    if not mask.any():
        return None
    ys, xs = np.where(mask)
    cy_rot = int(ys.min())
    cx_rot = int(np.median(xs[ys == cy_rot]))

    if M is not None:
        inv = cv2.invertAffineTransform(M)
        p = cv2.transform(np.array([[[cx_rot, cy_rot]]], np.float32), inv)
        ox, oy = int(p[0, 0, 0]), int(p[0, 0, 1])
    else:
        ox, oy = cx_rot, cy_rot

    dh, dw = depth_mm.shape
    x = max(0, min(ox, dw - 1)); y = max(0, min(oy, dh - 1))
    for win in (5, 11):
        hw = win // 2
        d = depth_mm[max(0, y - hw):y + hw + 1, max(0, x - hw):x + hw + 1]
        v = d[d > 0]
        if len(v):
            z = float(np.median(v)) / 1000.0
            break
    else:
        return None
    Y = (oy - CY) * z / FY
    return {"Y": Y, "row_rot": cy_rot, "orig": (ox, oy), "z": z}


def main():
    out = {}
    for stamp in STAMPS:
        bgr = cv2.imread(f"{BASE}/canopy_capture_{stamp}_HD.png")
        depth = cv2.imread(f"{BASE}/depth_snapshot_{stamp}_HD.png",
                           cv2.IMREAD_UNCHANGED)
        truth = float(open(f"{BASE}/canopy_y_{stamp}.txt").read())
        runs = [reference_canopy(bgr, depth, seed) for seed in range(5)]
        runs = [r for r in runs if r is not None]
        ys = sorted(r["Y"] for r in runs)
        rows = sorted(r["orig"][1] for r in runs)
        out[stamp] = {
            "truth": truth,
            "ref_algo_Y": ys,
            "ref_algo_rows": rows,
            "ref_algo_z": [round(r["z"], 4) for r in runs],
        }
        print(f"{stamp}: truth={truth:+.4f}  "
              f"ref Y over 5 seeds: {min(ys):+.4f}..{max(ys):+.4f}  "
              f"rows {rows[0]}..{rows[-1]}", flush=True)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
