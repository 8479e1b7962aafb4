"""TAN (gnomonic) WCS: a copy of ``lightcurver_tpu/io/wcs.py`` (``TanWCS``,
``upsampled_wcs`` and ``strip_wcs_cards``).

The FITS WCS paper-II TAN projection with a CD matrix and optional SIP
distortion. Conventions: pixel coordinates are 0-based (x along columns /
NAXIS1, y along rows / NAXIS2); CRPIX is 1-based as in FITS. All angles
degrees.
"""

import math

import numpy as np

DEG = math.pi / 180.0


def _sip_poly(coeffs, u, v):
    """Evaluate a SIP polynomial sum_pq c[p, q] u^p v^q (Shupe+ 2005)."""
    out = np.zeros(np.broadcast(u, v).shape, dtype=float)
    order = coeffs.shape[0] - 1
    for p in range(order + 1):
        for q in range(order + 1 - p):
            c = coeffs[p, q]
            if c != 0.0:
                out = out + c * u**p * v**q
    return out


def _parse_sip(header, prefix):
    """(order+1, order+1) coefficient matrix for A_/B_/AP_/BP_ cards."""
    okey = f"{prefix}_ORDER"
    if okey not in header:
        return None
    order = int(header[okey])
    coeffs = np.zeros((order + 1, order + 1), dtype=float)
    for p in range(order + 1):
        for q in range(order + 1 - p):
            key = f"{prefix}_{p}_{q}"
            if key in header:
                coeffs[p, q] = float(header[key])
    return coeffs


class TanWCS:
    """TAN projection with CD matrix, plus optional SIP distortion.

    SIP (Simple Imaging Polynomial, Shupe+ 2005 — the convention
    astrometry.net's solve-field writes as ``RA---TAN-SIP``):
    intermediate coordinates are ``CD @ (u + A(u, v), v + B(u, v))``
    with ``u = FITSx - CRPIX1``.  The inverse uses the AP/BP
    polynomials when present and polishes with Newton iterations on the
    exact forward model (sub-1e-6 px even without AP/BP).  The
    reference gets all of this from astropy.wcs; without SIP, edge-of-
    field star cutouts from a solve-field solution can be off by
    several pixels on wide-field frames.
    """

    def __init__(self, crval1, crval2, crpix1, crpix2, cd, sip_a=None,
                 sip_b=None, sip_ap=None, sip_bp=None):
        self.crval1 = float(crval1)
        self.crval2 = float(crval2)
        self.crpix1 = float(crpix1)
        self.crpix2 = float(crpix2)
        self.cd = np.asarray(cd, dtype=float).reshape(2, 2)
        self._cd_inv = np.linalg.inv(self.cd)
        as_arr = (lambda c: None if c is None
                  else np.asarray(c, dtype=float))
        self.sip_a = as_arr(sip_a)
        self.sip_b = as_arr(sip_b)
        self.sip_ap = as_arr(sip_ap)
        self.sip_bp = as_arr(sip_bp)

    @property
    def has_sip(self):
        return self.sip_a is not None or self.sip_b is not None

    def _distort(self, u, v):
        """(u, v) -> (u + A(u,v), v + B(u,v))."""
        if not self.has_sip:
            return u, v
        du = _sip_poly(self.sip_a, u, v) if self.sip_a is not None else 0.0
        dv = _sip_poly(self.sip_b, u, v) if self.sip_b is not None else 0.0
        return u + du, v + dv

    def _undistort(self, U, V, n_newton=3):
        """Invert :meth:`_distort`: AP/BP initial guess + Newton polish."""
        if not self.has_sip:
            return U, V
        u = U + (_sip_poly(self.sip_ap, U, V)
                 if self.sip_ap is not None else 0.0)
        v = V + (_sip_poly(self.sip_bp, U, V)
                 if self.sip_bp is not None else 0.0)
        # Newton on the exact forward model (the distortion is gentle:
        # derivatives approximated by identity converge in 2-3 steps)
        for _ in range(n_newton):
            fu, fv = self._distort(u, v)
            u = u - (fu - U)
            v = v - (fv - V)
        return u, v

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_header(cls, header):
        """Build from FITS cards: CD matrix, or PC matrix, or CDELT/CROTA2."""
        ctype1 = str(header.get("CTYPE1", "RA---TAN"))
        if "TAN" not in ctype1:
            raise ValueError(f"only TAN projection supported, got {ctype1}")
        crval1 = float(header["CRVAL1"])
        crval2 = float(header["CRVAL2"])
        crpix1 = float(header["CRPIX1"])
        crpix2 = float(header["CRPIX2"])
        # FITS: when ANY CDj_i is present, missing ones default to 0 —
        # a ~90deg-rotated solution may legitimately omit a zero CD1_1,
        # so detection must look at all four cards (same for PCj_i,
        # whose defaults are the identity)
        if any(k in header for k in ("CD1_1", "CD1_2", "CD2_1", "CD2_2")):
            cd = [[header.get("CD1_1", 0.0), header.get("CD1_2", 0.0)],
                  [header.get("CD2_1", 0.0), header.get("CD2_2", 0.0)]]
        elif any(k in header for k in ("PC1_1", "PC1_2", "PC2_1", "PC2_2")):
            cdelt1 = float(header.get("CDELT1", 1.0))
            cdelt2 = float(header.get("CDELT2", 1.0))
            pc = np.array([[header.get("PC1_1", 1.0), header.get("PC1_2", 0.0)],
                           [header.get("PC2_1", 0.0), header.get("PC2_2", 1.0)]],
                          dtype=float)
            cd = np.diag([cdelt1, cdelt2]) @ pc
        else:
            cdelt1 = float(header.get("CDELT1", 1.0))
            cdelt2 = float(header.get("CDELT2", 1.0))
            rho = float(header.get("CROTA2", 0.0)) * DEG
            cd = [[cdelt1 * math.cos(rho), -cdelt2 * math.sin(rho)],
                  [cdelt1 * math.sin(rho), cdelt2 * math.cos(rho)]]
        if "-SIP" in ctype1:
            # SIP applies only when CTYPE declares it; stale A_*/B_*
            # cards under a plain RA---TAN (distortion invalidated)
            # must be ignored, matching spec-conforming readers
            return cls(crval1, crval2, crpix1, crpix2, cd,
                       sip_a=_parse_sip(header, "A"),
                       sip_b=_parse_sip(header, "B"),
                       sip_ap=_parse_sip(header, "AP"),
                       sip_bp=_parse_sip(header, "BP"))
        return cls(crval1, crval2, crpix1, crpix2, cd)

    def to_header_cards(self):
        """Dict of FITS cards describing this WCS (SIP cards included)."""
        suffix = "-SIP" if self.has_sip else ""
        cards = {
            "CTYPE1": "RA---TAN" + suffix, "CTYPE2": "DEC--TAN" + suffix,
            "CRVAL1": self.crval1, "CRVAL2": self.crval2,
            "CRPIX1": self.crpix1, "CRPIX2": self.crpix2,
            "CD1_1": self.cd[0, 0], "CD1_2": self.cd[0, 1],
            "CD2_1": self.cd[1, 0], "CD2_2": self.cd[1, 1],
            "CUNIT1": "deg", "CUNIT2": "deg",
        }
        for prefix, coeffs in (("A", self.sip_a), ("B", self.sip_b),
                               ("AP", self.sip_ap), ("BP", self.sip_bp)):
            if coeffs is None:
                continue
            order = coeffs.shape[0] - 1
            cards[f"{prefix}_ORDER"] = order
            for p in range(order + 1):
                for q in range(order + 1 - p):
                    if coeffs[p, q] != 0.0:
                        cards[f"{prefix}_{p}_{q}"] = coeffs[p, q]
        return cards

    # -- transforms ----------------------------------------------------------

    def pixel_to_world(self, x, y):
        """0-based pixel (x, y) -> (ra, dec) degrees.  Vectorized."""
        x = np.asarray(x, dtype=float)
        y = np.asarray(y, dtype=float)
        u = x + 1.0 - self.crpix1
        v = y + 1.0 - self.crpix2
        u, v = self._distort(u, v)
        xi = (self.cd[0, 0] * u + self.cd[0, 1] * v) * DEG
        eta = (self.cd[1, 0] * u + self.cd[1, 1] * v) * DEG
        ra0 = self.crval1 * DEG
        dec0 = self.crval2 * DEG
        denom = np.sqrt(1.0 + xi**2 + eta**2)
        sin_dec = (np.sin(dec0) + eta * np.cos(dec0)) / denom
        dec = np.arcsin(np.clip(sin_dec, -1.0, 1.0))
        ra = ra0 + np.arctan2(xi, np.cos(dec0) - eta * np.sin(dec0))
        return (np.mod(ra / DEG, 360.0), dec / DEG)

    def world_to_pixel(self, ra, dec):
        """(ra, dec) degrees -> 0-based pixel (x, y).  Vectorized."""
        ra = np.asarray(ra, dtype=float) * DEG
        dec = np.asarray(dec, dtype=float) * DEG
        ra0 = self.crval1 * DEG
        dec0 = self.crval2 * DEG
        dra = ra - ra0
        den = (np.sin(dec0) * np.sin(dec)
               + np.cos(dec0) * np.cos(dec) * np.cos(dra))
        # den <= 0: the point is 90+ degrees from the tangent point and
        # has no gnomonic projection — without this guard the sign flip
        # would project its ANTIPODE into the image (e.g. contains_world
        # returning True for a target on the opposite sky).  NaN out,
        # like astropy; comparisons against NaN are False downstream.
        den = np.where(den > 1e-12, den, np.nan)
        xi = np.cos(dec) * np.sin(dra) / den / DEG
        eta = (np.cos(dec0) * np.sin(dec)
               - np.sin(dec0) * np.cos(dec) * np.cos(dra)) / den / DEG
        u = self._cd_inv[0, 0] * xi + self._cd_inv[0, 1] * eta
        v = self._cd_inv[1, 0] * xi + self._cd_inv[1, 1] * eta
        u, v = self._undistort(u, v)
        return (u + self.crpix1 - 1.0, v + self.crpix2 - 1.0)

    # -- derived quantities ---------------------------------------------------

    def pixel_scale_arcsec(self):
        """Geometric-mean pixel scale, arcsec/pixel."""
        return math.sqrt(abs(np.linalg.det(self.cd))) * 3600.0

    def pixel_anisotropy(self):
        """|sx - sy| / (sx + sy): the reference's bad-solution flag
        (processes/plate_solving.py:110-123)."""
        sx = math.hypot(self.cd[0, 0], self.cd[1, 0])
        sy = math.hypot(self.cd[0, 1], self.cd[1, 1])
        return abs(sx - sy) / (sx + sy)

    def north_angle_deg(self):
        """Position angle of celestial north measured from the +y axis of
        the image, counter-clockwise, degrees (utilities/footprint.py:202-224
        equivalent)."""
        cx, cy = self.crpix1 - 1.0, self.crpix2 - 1.0
        ra0, dec0 = self.pixel_to_world(cx, cy)
        step = 10.0 / 3600.0  # 10 arcsec north
        x1, y1 = self.world_to_pixel(ra0, dec0 + step)
        return math.degrees(math.atan2(-(x1 - cx), y1 - cy))

    def footprint_polygon(self, shape):
        """Corner (ra, dec) list for an image of ``shape`` (ny, nx).

        Corner RAs are unwrapped to be CONTINUOUS around the frame
        center (CRVAL1): a field straddling RA = 0 would otherwise mix
        corners near 359.9 with corners near 0.1 and every flat-plane
        polygon consumer (intersection/union, centroids, containment)
        would see a ~360-degree-wide footprint.  Values may therefore
        be slightly negative or above 360; consumers that need [0, 360)
        (the Gaia ADQL emitter) re-wrap with mod.
        """
        ny, nx = shape
        xs = np.array([0.0, nx - 1.0, nx - 1.0, 0.0])
        ys = np.array([0.0, 0.0, ny - 1.0, ny - 1.0])
        ra, dec = self.pixel_to_world(xs, ys)
        ra = self.crval1 + (ra - self.crval1 + 180.0) % 360.0 - 180.0
        return list(zip(ra.tolist(), dec.tolist()))

    def contains_world(self, ra, dec, shape, margin_pixels=0.0):
        """Is (ra, dec) inside the image (with optional inner margin)?"""
        x, y = self.world_to_pixel(ra, dec)
        ny, nx = shape
        m = margin_pixels
        return bool(np.all((x >= m) & (x <= nx - 1 - m)
                           & (y >= m) & (y <= ny - 1 - m)))


def upsampled_wcs(wcs, s):
    """WCS of the s-times-subsampled fine grid of ``wcs``'s image.

    Fine pixel x_f relates to data pixel x_d through the sum-pool
    blocks of the numerical core (core/grids.py): data pixel x_d spans
    fine pixels [s*x_d, s*x_d + s - 1], center s*x_d + (s-1)/2.  Hence
    CRPIX_f = s*CRPIX_d - (s-1)/2 and CD_f = CD_d / s.  (The reference
    writes plain ``crpix *= s`` for its high-res products — reference
    processes/roi_modelling.py:391 — which offsets every source by
    (s-1)/2 fine pixels; this implements the exact alignment.)  SIP
    coefficients rescale as A'_pq = A_pq * s^(1-p-q) so the distortion
    field is preserved in fine-pixel units.
    """
    s = int(s)

    def rescale(coeffs):
        if coeffs is None:
            return None
        out = np.array(coeffs, dtype=float)
        order = out.shape[0] - 1
        for p in range(order + 1):
            for q in range(order + 1 - p):
                out[p, q] *= float(s) ** (1 - p - q)
        return out

    return TanWCS(wcs.crval1, wcs.crval2,
                  s * wcs.crpix1 - (s - 1) / 2.0,
                  s * wcs.crpix2 - (s - 1) / 2.0,
                  wcs.cd / s,
                  sip_a=rescale(wcs.sip_a), sip_b=rescale(wcs.sip_b),
                  sip_ap=rescale(wcs.sip_ap),
                  sip_bp=rescale(wcs.sip_bp))


def strip_wcs_cards(header):
    """Remove the WCS cards from a Header in place (the import strips them
    when the plate-solving task will write a fresh WCS)."""
    prefixes = ("CTYPE", "CRVAL", "CRPIX", "CD1_", "CD2_", "CDELT", "CROTA",
                "PC1_", "PC2_", "CUNIT", "PV1_", "PV2_", "A_", "B_", "AP_",
                "BP_", "WCSAXES", "LONPOLE", "LATPOLE", "EQUINOX", "RADESYS")
    for key in list(header.keys()):
        if any(key.startswith(p) for p in prefixes):
            del header[key]
    return header
