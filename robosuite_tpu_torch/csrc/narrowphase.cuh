// Narrowphase of one scenario over its team: every candidate point of
// every pair, the manifold cut to each pair's deepest points, and, per kept
// row, the candidate's point and normal.
//
// The formulas are physics/contact.py's (the JAX package's lane formulas,
// robosuite_tpu/ops/pallas_substep.py _np_plane_box, _np_capsule_box,
// _np_box_box, _np_box_box_edges, _np_plane_cylinder, _np_capsule_capsule),
// including their floors. Lanes go over
// every (pair, candidate), grouped by the branch that computes it
// (ops/tables.py cand_pi): each lane computes one candidate's depth on its
// own, into the flat pair-major list (pair_cand). A box-box pair emits an
// edge-cross candidate only where its separation is within 1e-9 of the
// pair's best edge and beats every face separation (max_face). The cut is
// the team argmin, repeated per kept row, which keeps the earliest
// candidate on ties, the order contact.select_deepest (a stable sort)
// gives: a different tie rule would put other points in a row and change
// f row by row. Only depths are stored; a kept row's point and normal are
// computed again from its candidate index where the row is assembled.
#pragma once

#include "forward.cuh"

#define RS_BIG 1e4f
#define RS_PF 25  // a pair's frame: p1, R1, p2, R2, and the box-box max_face

// Candidates per pair kind (plane-box, capsule-box, box-box,
// plane-cylinder, capsule-capsule).
RS_DEV int pair_ncand(int kind) {
  return kind == RS_PAIR_PLANE_BOX ? 8
         : kind == RS_PAIR_CAPSULE_BOX ? 2
         : kind == RS_PAIR_BOX_BOX ? 25
         : kind == RS_PAIR_PLANE_CYLINDER ? 3
                                          : 1;
}

RS_DEV void mat_vec(const float* R, const float* v, float* o) {
  for (int i = 0; i < 3; ++i) o[i] = R[i * 3 + 0] * v[0] + R[i * 3 + 1] * v[1] + R[i * 3 + 2] * v[2];
}

RS_DEV void matT_vec(const float* R, const float* v, float* o) {
  for (int i = 0; i < 3; ++i) o[i] = R[0 * 3 + i] * v[0] + R[1 * 3 + i] * v[1] + R[2 * 3 + i] * v[2];
}

RS_DEV void mat_col(const float* R, int i, float* o) {
  o[0] = R[i]; o[1] = R[3 + i]; o[2] = R[6 + i];
}

RS_DEV float norm3(const float* v) { return sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]); }

// Signed distance from the box surface to a local point, outward local
// normal; inside, a softmax blend (2 mm) of the face normals.
RS_DEV float point_box(const float* pl, const float* half, float* n) {
  float q[3], out[3];
  for (int i = 0; i < 3; ++i) { q[i] = fabsf(pl[i]) - half[i]; out[i] = fmaxf(q[i], 0.0f); }
  float d_out = norm3(out);
  float d_in = fmaxf(fmaxf(q[0], q[1]), q[2]);
  if (d_out < 1e-9f) {
    float e[3], raw[3];
    for (int i = 0; i < 3; ++i) e[i] = expf((q[i] - d_in) / 2e-3f);
    float se = e[0] + e[1] + e[2];
    for (int i = 0; i < 3; ++i) raw[i] = signf(pl[i]) * (e[i] / se);
    float nn = fmaxf(norm3(raw), 1e-9f);
    for (int i = 0; i < 3; ++i) n[i] = raw[i] / nn;
    return d_in;
  }
  for (int i = 0; i < 3; ++i) n[i] = signf(pl[i]) * out[i] / fmaxf(d_out, 1e-9f);
  return d_out;
}

RS_DEV void corner(int c, const float* s, float* off) {
  off[0] = ((c >> 2) & 1 ? 1.0f : -1.0f) * s[0];
  off[1] = ((c >> 1) & 1 ? 1.0f : -1.0f) * s[1];
  off[2] = (c & 1 ? 1.0f : -1.0f) * s[2];
}

// The largest face separation of a box-box pair (the SAT face axes of
// both boxes).
RS_DEV float box_box_max_face(const float* p1, const float* R1, const float* s1, const float* p2, const float* R2,
                              const float* s2) {
  float dp[3], A[3][3], Bx[3][3];
  for (int i = 0; i < 3; ++i) dp[i] = p2[i] - p1[i];
  for (int i = 0; i < 3; ++i) { mat_col(R1, i, A[i]); mat_col(R2, i, Bx[i]); }
  float max_face = -INFINITY;
  for (int side = 0; side < 2; ++side) {
    const float(*ax)[3] = side == 0 ? A : Bx;
    const float(*ox)[3] = side == 0 ? Bx : A;
    const float* hs = side == 0 ? s1 : s2;
    const float* ho = side == 0 ? s2 : s1;
    for (int k = 0; k < 3; ++k) {
      float proj = 0.0f;
      for (int m = 0; m < 3; ++m) proj += ho[m] * fabsf(v3_dot(ax[k], ox[m]));
      max_face = fmaxf(max_face, fabsf(v3_dot(ax[k], dp)) - hs[k] - proj);
    }
  }
  return max_face;
}

// Edge-cross candidate idx = 3 i + j (edge i of box1 x edge j of box2):
// its separation (-INF where the cross product degenerates), midpoint of
// the closest points, and axis.
RS_DEV float box_box_edge(const float* p1, const float* R1, const float* s1, const float* p2, const float* R2,
                          const float* s2, int idx, float* pos, float* axis) {
  float dp[3], A[3][3], Bx[3][3];
  for (int k = 0; k < 3; ++k) dp[k] = p2[k] - p1[k];
  for (int k = 0; k < 3; ++k) { mat_col(R1, k, A[k]); mat_col(R2, k, Bx[k]); }
  const int i = idx / 3, j = idx % 3;
  const float* a = A[i];
  const float* b = Bx[j];
  v3_cross(a, b, axis);
  float nrm = norm3(axis);
  bool valid = nrm > 1e-6f;
  float inv = 1.0f / fmaxf(nrm, 1e-6f);
  for (int k = 0; k < 3; ++k) axis[k] *= inv;
  float sgn = v3_dot(axis, dp) < 0.0f ? -1.0f : 1.0f;
  for (int k = 0; k < 3; ++k) axis[k] *= sgn;
  float proj1 = 0.0f, proj2 = 0.0f;
  for (int k = 0; k < 3; ++k) {
    proj1 += s1[k] * fabsf(v3_dot(axis, A[k]));
    proj2 += s2[k] * fabsf(v3_dot(axis, Bx[k]));
  }
  float sep = v3_dot(axis, dp) - proj1 - proj2;
  float c1[3], c2[3];
  for (int k = 0; k < 3; ++k) { c1[k] = p1[k]; c2[k] = p2[k]; }
  for (int k = 0; k < 3; ++k) {
    if (k != i) {
      float f = signf(v3_dot(axis, A[k])) * s1[k];
      for (int m = 0; m < 3; ++m) c1[m] += f * A[k][m];
    }
    if (k != j) {
      float f = signf(v3_dot(axis, Bx[k])) * s2[k];
      for (int m = 0; m < 3; ++m) c2[m] -= f * Bx[k][m];
    }
  }
  float r[3];
  for (int k = 0; k < 3; ++k) r[k] = c2[k] - c1[k];
  float ab = v3_dot(a, b);
  float den = fmaxf(1.0f - ab * ab, 1e-9f);
  float t1 = clampf((v3_dot(a, r) - ab * v3_dot(b, r)) / den, -s1[i], s1[i]);
  float t2 = clampf((ab * v3_dot(a, r) - v3_dot(b, r)) / den, -s2[j], s2[j]);
  for (int k = 0; k < 3; ++k) pos[k] = 0.5f * ((c1[k] + t1 * a[k]) + (c2[k] + t2 * b[k]));
  return valid ? sep : -INFINITY;
}

// Plane (frame p1, R1) vs cylinder (p2, R2, radius s2[0], half length
// s2[1]), candidate i: the rim point of the +z cap (i = 0) or of the -z cap
// (i = 1) nearest the plane, or the centre of the +z cap (i = 2). The rim
// direction is the plane normal's descent across the cap, -(n - (a.n) a)
// normalised, or the cylinder's x axis where the axis is parallel to the
// normal (|n - (a.n) a| <= 1e-8). -> the depth; the point and the normal.
RS_DEV float plane_cylinder(const float* p1, const float* R1, const float* p2, const float* R2, const float* s2,
                            int i, float* pos, float* nrm) {
  float axis[3], proj[3], rim[3], pt[3], t[3];
  mat_col(R1, 2, nrm);
  mat_col(R2, 2, axis);
  const float an = v3_dot(axis, nrm);
  for (int k = 0; k < 3; ++k) proj[k] = nrm[k] - an * axis[k];
  const float pn = norm3(proj);
  const float inv = 1.0f / fmaxf(pn, 1e-8f);
  if (pn > 1e-8f)
    for (int k = 0; k < 3; ++k) rim[k] = -proj[k] * inv;
  else
    mat_col(R2, 0, rim);
  const float h = i == 1 ? -s2[1] : s2[1], r = i == 2 ? 0.0f : s2[0];
  for (int k = 0; k < 3; ++k) {
    pt[k] = p2[k] + h * axis[k];
    if (i < 2) pt[k] += r * rim[k];
    t[k] = pt[k] - p1[k];
  }
  const float d = v3_dot(t, nrm);
  for (int k = 0; k < 3; ++k) pos[k] = pt[k] - 0.5f * d * nrm[k];
  return d;
}

// Capsule vs capsule (a cylinder as its capsule): the closest points of the
// two axis segments a0 + s (a1 - a0), b0 + t (b1 - b0), s from the
// unclamped solution (0 where the segments are parallel, den <= 1e-12), t
// from s, s again from t, each clamped to [0, 1]. -> the depth (the
// distance less both radii); the point (half the depth from the first
// surface) and the normal (first axis toward the second).
RS_DEV float capsule_capsule(const float* p1, const float* R1, const float* s1, const float* p2, const float* R2,
                             const float* s2, float* pos, float* nrm) {
  float a0[3], da[3], b0[3], db[3], r[3], pa[3], dp[3];
  for (int k = 0; k < 3; ++k) {
    const float ua = s1[1] * R1[k * 3 + 2], ub = s2[1] * R2[k * 3 + 2];
    a0[k] = p1[k] - ua;
    b0[k] = p2[k] - ub;
    da[k] = (p1[k] + ua) - a0[k];
    db[k] = (p2[k] + ub) - b0[k];
    r[k] = a0[k] - b0[k];
  }
  const float A = v3_dot(da, da) + 1e-12f, B = v3_dot(da, db), C = v3_dot(db, db) + 1e-12f;
  const float D = v3_dot(da, r), E = v3_dot(db, r);
  const float den = A * C - B * B;
  float s = clampf(den > 1e-12f ? (B * E - C * D) / fmaxf(den, 1e-12f) : 0.0f, 0.0f, 1.0f);
  const float t = clampf((B * s + E) / C, 0.0f, 1.0f);
  s = clampf((B * t - D) / A, 0.0f, 1.0f);
  for (int k = 0; k < 3; ++k) {
    pa[k] = a0[k] + s * da[k];
    dp[k] = (b0[k] + t * db[k]) - pa[k];
  }
  const float dist = norm3(dp);
  const float inv = 1.0f / fmaxf(dist, 1e-9f);
  for (int k = 0; k < 3; ++k) nrm[k] = inv * dp[k];
  const float d = dist - s1[0] - s2[0];
  for (int k = 0; k < 3; ++k) pos[k] = pa[k] + (s1[0] + 0.5f * d) * nrm[k];
  return d;
}

// The depth a box-box edge candidate enters the cut with: its separation
// where emitted, else RS_BIG.
RS_DEV float edge_depth(float sep, float best, float max_face) {
  return (sep > -INFINITY && sep >= best - 1e-9f && sep > max_face) ? sep : RS_BIG;
}

// Candidate i of pair p at the pair's frame pf (normals from geom1 into
// geom2 in model order): -> its raw depth (a box-box edge: the separation,
// see edge_depth), its point and normal.
RS_DEV float candidate(const RsTables& T, const float* pf, int p, int i, float* pos, float* nrm) {
  const float *p1 = pf, *R1 = pf + 3, *p2 = pf + 12, *R2 = pf + 15;
  const float *s1 = T.geom_size[T.pair_g1[p]], *s2 = T.geom_size[T.pair_g2[p]];
  const int kind = T.pair_kind[p];
  float d, off[3], t[3], pt[3], pl[3], nl[3];
  if (kind == RS_PAIR_PLANE_BOX) {
    mat_col(R1, 2, nrm);
    corner(i, s2, off);
    mat_vec(R2, off, t);
    for (int k = 0; k < 3; ++k) { pt[k] = p2[k] + t[k]; t[k] = pt[k] - p1[k]; }
    d = v3_dot(t, nrm);
    for (int k = 0; k < 3; ++k) pos[k] = pt[k] - 0.5f * d * nrm[k];
  } else if (kind == RS_PAIR_CAPSULE_BOX) {
    float ax[3], e[3];
    mat_col(R1, 2, ax);
    float sgn = i == 0 ? -1.0f : 1.0f;
    for (int k = 0; k < 3; ++k) { e[k] = p1[k] + (sgn * s1[1]) * ax[k]; t[k] = e[k] - p2[k]; }
    matT_vec(R2, t, pl);
    float ds = point_box(pl, s2, nl);
    mat_vec(R2, nl, nrm);
    for (int k = 0; k < 3; ++k) nrm[k] = -nrm[k];
    d = ds - s1[0];
    for (int k = 0; k < 3; ++k) pos[k] = e[k] + (s1[0] + 0.5f * d) * nrm[k];
  } else if (kind == RS_PAIR_PLANE_CYLINDER) {
    d = plane_cylinder(p1, R1, p2, R2, s2, i, pos, nrm);
  } else if (kind == RS_PAIR_CAPSULE_CAPSULE) {
    d = capsule_capsule(p1, R1, s1, p2, R2, s2, pos, nrm);
  } else if (i < 16) {  // a corner of box1 vs box2 (i < 8), or of box2 vs box1; one code path for both
    const bool first = i < 8;
    const float *pa = first ? p1 : p2, *Ra = first ? R1 : R2, *sa = first ? s1 : s2;
    const float *pb = first ? p2 : p1, *Rb = first ? R2 : R1, *sb = first ? s2 : s1;
    corner(i & 7, sa, off);
    mat_vec(Ra, off, t);
    for (int k = 0; k < 3; ++k) { pt[k] = pa[k] + t[k]; t[k] = pt[k] - pb[k]; }
    matT_vec(Rb, t, pl);
    d = point_box(pl, sb, nl);
    mat_vec(Rb, nl, nrm);
    // the point moves half the depth against box b's outward normal; the
    // contact normal points from box1 toward box2
    for (int k = 0; k < 3; ++k) {
      pos[k] = pt[k] - 0.5f * d * nrm[k];
      if (first) nrm[k] = -nrm[k];
    }
  } else {
    d = box_box_edge(p1, R1, s1, p2, R2, s2, i - 16, pos, nrm);
  }
  if (T.pair_flip[p])
    for (int k = 0; k < 3; ++k) nrm[k] = -nrm[k];
  return d;
}

// The narrowphase's shared memory: pair frames, candidate depths, and
// each kept row's candidate and depth.
struct Narrow {
  float (*pf)[RS_PF];
  float* cd;
  int* row_cand;
  float* row_dist;
};

// Pair frames, then every candidate's depth (raw, see candidate); ends
// synchronised.
template <class Team>
RS_DEV void candidates_team(const Team& tm, const RsTables& T, const Fwd& s, const Narrow& nw) {
  for (int p = tm.rank(); p < T.npair; p += tm.size()) {
    int g1 = T.pair_g1[p], g2 = T.pair_g2[p];
    float* f = nw.pf[p];
    frame_pose(s, T.geom_bodyid[g1], T.geom_pos[g1], T.geom_quat[g1], f, f + 3);
    frame_pose(s, T.geom_bodyid[g2], T.geom_pos[g2], T.geom_quat[g2], f + 12, f + 15);
    f[24] = T.pair_kind[p] == RS_PAIR_BOX_BOX ? box_box_max_face(f, f + 3, T.geom_size[g1], f + 12, f + 15,
                                                                 T.geom_size[g2])
                                              : 0.0f;
  }
  tm.sync();
  // in the table's path order (cand_pi), so a warp's lanes mostly run one
  // branch of candidate() at a time; depths land in the flat pair order
  for (int e = tm.rank(); e < T.ncand; e += tm.size()) {
    const int p = T.cand_pi[e] >> 5, i = T.cand_pi[e] & 31;
    float pos[3], nrm[3];
    nw.cd[T.pair_cand[p] + i] = candidate(T, nw.pf[p], p, i, pos, nrm);
  }
  tm.sync();
}

// The manifold cut of one pair: the npts deepest of its nc candidate
// depths d, deepest first, the earliest on ties (a kept candidate's depth
// is raised by RS_BIG, as the tournament does), into cand / dist; a pair
// with no more candidates than rows passes them through. Ends synchronised.
template <class Team>
RS_DEV void cut_team(const Team& tm, float* d, int nc, int npts, int* cand, float* dist) {
  if (nc <= npts) {
    for (int r = tm.rank(); r < npts; r += tm.size()) {
      cand[r] = r;
      dist[r] = d[r];
    }
    tm.sync();
    return;
  }
  for (int r = 0; r < npts; ++r) {
    const int bi = team_argmin(tm, d, nc);
    tm.sync();
    if (tm.rank() == 0) {
      cand[r] = bi;
      dist[r] = d[bi];
      d[bi] += RS_BIG;
    }
    tm.sync();
  }
}

// The narrowphase into (row_cand, row_dist): candidates, each box-box
// pair's edge emission (edge_depth), and the cut; ends synchronised.
template <class Team>
RS_DEV void narrowphase_team(const Team& tm, const RsTables& T, const Fwd& s, const Narrow& nw) {
  candidates_team(tm, T, s, nw);
  for (int p = 0; p < T.npair; ++p) {
    const int off = T.pair_cand[p], row0 = T.pair_row[p];
    float* d = nw.cd + off;
    if (T.pair_kind[p] == RS_PAIR_BOX_BOX) {
      float best = -INFINITY;
      for (int i = 16 + tm.rank(); i < 25; i += tm.size()) best = fmaxf(best, d[i]);
      best = tm.max(best);
      for (int i = 16 + tm.rank(); i < 25; i += tm.size()) d[i] = edge_depth(d[i], best, nw.pf[p][24]);
      tm.sync();
    }
    cut_team(tm, d, T.pair_cand[p + 1] - off, T.pair_npts[p], nw.row_cand + row0, nw.row_dist + row0);
  }
}

// Each pair's minimum candidate depth (the minimum over all candidates is
// the minimum over the rows the cut keeps, which are the deepest), one lane
// per pair, into out[pair_k[p]]. Expects candidates_team to have run.
template <class Team>
RS_DEV void pair_min_team(const Team& tm, const RsTables& T, const Narrow& nw, float* out) {
  for (int p = tm.rank(); p < T.npair; p += tm.size()) {
    const int off = T.pair_cand[p], nc = T.pair_cand[p + 1] - off;
    const float* d = nw.cd + off;
    float best = -INFINITY, m = INFINITY;
    if (T.pair_kind[p] == RS_PAIR_BOX_BOX)
      for (int i = 16; i < 25; ++i) best = fmaxf(best, d[i]);
    for (int i = 0; i < nc; ++i)
      m = fminf(m, T.pair_kind[p] == RS_PAIR_BOX_BOX && i >= 16 ? edge_depth(d[i], best, nw.pf[p][24]) : d[i]);
    out[T.pair_k[p]] = m;
  }
}
