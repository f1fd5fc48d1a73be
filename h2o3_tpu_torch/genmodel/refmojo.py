"""Reference-format MOJO export for tree models (GBM/DRF).

The port's copy of h2o3_tpu/genmodel/refmojo.py; the port imports nothing
of the reference package, so it keeps its own.

Emits the ACTUAL reference MOJO zip layout — model.ini + domains/dNNN.txt
+ trees/tCC_TTT.bin — with tree blobs in the SharedTreeMojoModel v1.40
byte format, so the reference genmodel runtime can score our models:

- blob grammar (hex/tree/DTree.java compress() writer,
  hex/genmodel/algos/tree/SharedTreeMojoModel.java:129 scoreTree reader):
  node = [1B nodeType][2B colId][1B naSplitDir]
         [4B float splitVal | bitset]
         [left-subtree size (1-4B, width from nodeType bits 0-1,
          absent when left child is a leaf)]
         [left subtree][right subtree];  leaf = [4B float]
  nodeType bits: 0-1 left-size width-1, 2-3 equal (0 numeric,
  12 bitset via compress3), 48 left-is-leaf, 192 right-is-leaf.
- bitset (compress3, GenmodelBitSet.fill3): [2B bitoff=0][4B nbits]
  [ceil(nbits/8) bytes], bit set ⇔ category goes RIGHT (scoreTree:
  bs.contains(d) → right branch).
- numeric: go left ⇔ value < splitVal; our bin<=t split maps to
  splitVal = edges[f][t] exactly (bin counts edges <= x).
- byte order: native little-endian (ByteBufferWrapper nativeOrder).

`score_reference_mojo` is an independent decoder following the reader
byte-for-byte — the round-trip contract check this format ships with.
"""

from __future__ import annotations

import struct
import uuid as _uuid
import zipfile
from typing import Dict, List, Optional

import numpy as np

NA_LEFT, NA_RIGHT = 2, 3                     # NaSplitDir NALeft / NARight


# ---------------------------------------------------------------- writer


def _leaf_bytes(val: float) -> bytes:
    return struct.pack("<f", float(val))


def _node_bytes(feat, thresh, na_left, is_split, cat_split, left_words,
                leaf, edges, cards, divs, d, l, D) -> bytes:
    """Serialize node (d, l) of a complete-layout tree, recursively."""
    if d == D or not is_split[d, l]:
        return _leaf_bytes(leaf[l << (D - d)])
    f = int(feat[d, l])
    t = int(thresh[d, l])
    nal = bool(na_left[d, l])
    left = _node_bytes(feat, thresh, na_left, is_split, cat_split,
                       left_words, leaf, edges, cards, divs,
                       d + 1, 2 * l, D)
    right = _node_bytes(feat, thresh, na_left, is_split, cat_split,
                        left_words, leaf, edges, cards, divs,
                        d + 1, 2 * l + 1, D)
    left_is_leaf = (d + 1 == D) or not is_split[d + 1, 2 * l]
    right_is_leaf = (d + 1 == D) or not is_split[d + 1, 2 * l + 1]

    node_type = 0
    payload = b""
    if bool(cat_split[d, l]):
        node_type |= 12                       # bitset split (compress3)
        card = int(cards[f])
        div = int(divs[f])
        words = left_words[d, l]
        bits = bytearray((card + 7) >> 3)
        for lvl in range(card):
            b = lvl // div
            in_left = (int(words[b >> 5]) >> (b & 31)) & 1
            if not in_left:                   # bitset marks RIGHT-goers
                bits[lvl >> 3] |= 1 << (lvl & 7)
        payload = struct.pack("<HI", 0, card) + bytes(bits)
    else:
        e = edges[f]
        sv = float(e[t]) if t < len(e) else float("inf")
        payload = struct.pack("<f", sv)

    if left_is_leaf:
        node_type |= 48
        size_field = b""
    else:
        lsz = len(left)
        if lsz < 256:
            slen, size_field = 0, struct.pack("<B", lsz)
        elif lsz < 65535:
            slen, size_field = 1, struct.pack("<H", lsz)
        elif lsz < (1 << 24):
            slen, size_field = 2, struct.pack("<I", lsz)[:3]
        else:
            slen, size_field = 3, struct.pack("<i", lsz)
        node_type |= slen
    if right_is_leaf:
        node_type |= 192
    head = struct.pack("<BHB", node_type, f, NA_LEFT if nal else NA_RIGHT)
    return head + payload + size_field + left + right


def _root_blob(feat, thresh, na_left, is_split, cat_split, left_words,
               leaf, edges, cards, divs, D) -> bytes:
    if not is_split[0, 0]:
        # root leaf: nodeType byte, colId 0xFFFF sentinel, float value
        return struct.pack("<BH", 0, 0xFFFF) + _leaf_bytes(leaf[0])
    return _node_bytes(feat, thresh, na_left, is_split, cat_split,
                       left_words, leaf, edges, cards, divs, 0, 0, D)


def write_reference_mojo(model, path: str) -> str:
    """Write a reference-layout MOJO zip for a GBM/DRF model."""
    from h2o3_tpu_torch.models.model import ModelCategory
    bm = model.bm
    out = model.output
    f = model.forest
    feat = np.asarray(f.feat)
    thresh = np.asarray(f.thresh)
    na_left = np.asarray(f.na_left)
    is_split = np.asarray(f.is_split)
    cat_split = np.asarray(f.cat_split)
    left_words = np.asarray(f.left_words)
    leaf = np.asarray(f.leaf, np.float64)
    D = feat.shape[1]

    host_edges = np.asarray(bm.edges)
    edges = [e[np.isfinite(e)] for e in host_edges]
    cards = [len(d) if d else 1 for d in bm.domains]
    nb = np.asarray(bm.nbins)
    divs = [max(1, -(-cards[i] // max(int(nb[i]), 1)))
            if bm.is_cat[i] and cards[i] > int(nb[i]) else 1
            for i in range(len(cards))]

    cat = out["category"]
    K = out.get("nclasses", 1) if cat == ModelCategory.MULTINOMIAL else 1
    T_total = feat.shape[0]
    n_groups = T_total // K
    n_classes = (out.get("nclasses", 2)
                 if cat in (ModelCategory.BINOMIAL,
                            ModelCategory.MULTINOMIAL) else 1)

    names = list(bm.names) + [out["response"]]
    rdom = out.get("domain")
    domains: List[Optional[List[str]]] = list(bm.domains) + [rdom]

    info = _base_info(
        model,
        category={ModelCategory.BINOMIAL: "Binomial",
                  ModelCategory.MULTINOMIAL: "Multinomial"}.get(
                      cat, "Regression"),
        n_features=len(bm.names), n_classes=n_classes,
        n_columns=len(names),
        n_domains=sum(1 for d in domains if d is not None))
    info.update({
        "mojo_version": "1.40",
        "algo": model.algo,
        "algorithm": ("Gradient Boosting Machine" if model.algo == "gbm"
                      else "Distributed Random Forest"),
        "prior_class_distrib": "null",
        "model_class_distrib": "null",
        "timestamp": "2026-01-01 00:00:00",
        "n_trees": n_groups,
        "n_trees_per_class": K,
    })
    if model.algo == "gbm":
        link = {"bernoulli": "logit", "multinomial": "logit",
                "poisson": "log", "gamma": "log", "tweedie": "log"}.get(
                    model.dist_name, "identity")
        info.update(distribution=model.dist_name,
                    init_f=float(np.asarray(model.f0).ravel()[0]),
                    link_function=link)
    else:
        info.update(binomial_double_trees="false")

    def _blobs():
        for g in range(n_groups):
            for k in range(K):
                idx = g * K + k
                yield (f"trees/t{k:02d}_{g:03d}.bin", _root_blob(
                    feat[idx], thresh[idx], na_left[idx], is_split[idx],
                    cat_split[idx], left_words[idx], leaf[idx],
                    edges, cards, divs, D))
    return _emit_mojo_zip(path, info, names, domains, _blobs())


# ------------------------------------------------------ shared ini emission


def _base_info(model, category: str, n_features: int, n_classes: int,
               n_columns: int, n_domains: int) -> Dict[str, object]:
    """[info] fields every reference MOJO carries (ModelMojoReader
    readAll contract)."""
    return {
        "h2o_version": "3.46.0.1",
        "license": "Apache License Version 2.0",
        "endianness": "LITTLE_ENDIAN",
        "category": category,
        "uuid": str(abs(hash(model.key)) if model.key else
                    _uuid.uuid4().int % (1 << 63)),
        "supervised": "true",
        "n_features": n_features,
        "n_classes": n_classes,
        "n_columns": n_columns,
        "n_domains": n_domains,
        "balance_classes": "false",
        "default_threshold": model.output.get("default_threshold", 0.5),
    }


def _emit_mojo_zip(path: str, info: Dict[str, object], names: List[str],
                   domains: List[Optional[List[str]]],
                   blobs=None) -> str:
    """Write model.ini + domains/dNNN.txt (+ extra binary entries) —
    the zip layout both the tree and GLM writers share. ``blobs`` is an
    iterable of (entry_name, bytes) pairs, consumed lazily so a large
    forest never materializes every serialized tree at once."""
    ini = ["[info]"]
    ini += [f"{k} = {v}" for k, v in info.items()]
    ini += ["", "[columns]"]
    ini += names
    ini += ["", "[domains]"]
    dom_files: Dict[str, List[str]] = {}
    di = 0
    for i, d in enumerate(domains):
        if d is None:
            continue
        fn = f"d{di:03d}.txt"
        ini.append(f"{i}: {len(d)} {fn}")
        dom_files[fn] = list(d)
        di += 1
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("model.ini", "\n".join(ini) + "\n")
        for fn, lvls in dom_files.items():
            z.writestr(f"domains/{fn}", "\n".join(lvls) + "\n")
        for name, blob in (blobs or ()):
            z.writestr(name, blob)
    return path


# ----------------------------------------------------------- GLM writer


def _jarr(vals) -> str:
    """Java ``Arrays.toString`` serialization — the writekv array format
    (hex/genmodel/AbstractMojoWriter.java writekv(String, double[]))."""
    return "[" + ", ".join(repr(float(v)) if isinstance(v, float)
                           else str(int(v)) for v in vals) + "]"


def write_reference_glm_mojo(model, path: str) -> str:
    """Write a reference-layout GLM MOJO zip (GlmMojoReader v1.00
    contract, hex/glm/GLMMojoWriter.java writeModelData):

    - beta layout: categorical one-hot blocks first (catOffsets), then
      numerics, then intercept — RAW scale (GlmMojoModel.glmScore0
      applies no standardization).
    - columns reordered categoricals-first to match the data[] indexing
      ``i < cats ⇒ categorical code`` (GlmMojoModelBase).
    - NA semantics: cat_modes[i] = cardinality (an out-of-range code)
      reproduces our all-zero-indicator NA block exactly — glmScore0
      skips the coefficient when ival reaches catOffsets[i+1].
    """
    from h2o3_tpu_torch.models.model import ModelCategory
    if model.coef_multinomial is not None or \
            model.output.get("family") == "ordinal":
        # ordinal trains with a placeholder intercept + separate
        # thresholds (ordinal_alphas) that GlmMojoModel cannot express
        raise ValueError("reference-format GLM MOJO export does not "
                         "cover multinomial/ordinal yet")
    feats = list(model.features)
    domains_by_feat = model.di_stats["domains"]
    use_all = bool(model.params.get("use_all_factor_levels", False))
    first = 0 if use_all else 1
    coefs = model.coefficients  # raw scale, keyed by coef name

    cats_i = [i for i, d in enumerate(domains_by_feat) if d is not None]
    nums_i = [i for i, d in enumerate(domains_by_feat) if d is None]
    cat_offsets = [0]
    beta: List[float] = []
    cat_modes: List[int] = []
    for i in cats_i:
        dom = domains_by_feat[i]
        for l in range(first, max(len(dom), 1)):
            beta.append(coefs[f"{feats[i]}.{dom[l]}"])
        cat_offsets.append(len(beta))
        cat_modes.append(max(len(dom), 1))
    num_means = [float(m) for m in model.di_stats["num_means"]]
    for i in nums_i:
        beta.append(coefs[feats[i]])
    beta.append(coefs["Intercept"])

    fam = model.family
    cat = model.output["category"]
    binomial = cat == ModelCategory.BINOMIAL
    names = ([feats[i] for i in cats_i] + [feats[i] for i in nums_i]
             + [model.output["response"]])
    domains: List[Optional[List[str]]] = (
        [list(domains_by_feat[i]) for i in cats_i]
        + [None] * len(nums_i) + [model.output.get("domain")])

    info = _base_info(model, category="Binomial" if binomial
                      else "Regression", n_features=len(feats),
                      n_classes=2 if binomial else 1,
                      n_columns=len(names),
                      n_domains=sum(1 for d in domains if d is not None))
    info.update({
        "mojo_version": "1.00",
        "algo": "glm",
        "algorithm": "Generalized Linear Model",
        # GLMMojoWriter.writeModelData kv block
        "use_all_factor_levels": "true" if use_all else "false",
        "cats": len(cats_i),
        "cat_offsets": _jarr(cat_offsets),
        "nums": len(nums_i),
        "mean_imputation": "true",
        "num_means": _jarr(num_means),
        "cat_modes": _jarr(cat_modes),
        "beta": _jarr([float(b) for b in beta]),
        "family": fam.name,
        "link": fam.link,
    })
    if fam.name == "tweedie":
        # our tweedie linkinv is exp (log link); power 0 selects
        # Math.exp in GenModel.GLM_tweedieInv
        info["tweedie_link_power"] = 0.0
    return _emit_mojo_zip(path, info, names, domains)


def _parse_jarr(s: str) -> List[float]:
    s = s.strip()[1:-1].strip()
    return [float(x) for x in s.split(",")] if s else []


def score_reference_glm_mojo(path: str, rows: Dict[str, np.ndarray]):
    """Faithful port of GlmMojoModel.score0 (mean imputation +
    glmScore0 + link inverse) reading our reference-layout GLM zip —
    the round-trip contract check. Returns mu [n]."""
    with zipfile.ZipFile(path) as z:
        ini = z.read("model.ini").decode().splitlines()
        info: Dict[str, str] = {}
        columns: List[str] = []
        domain_spec: Dict[int, str] = {}
        section = None
        for ln in ini:
            ln = ln.strip()
            if not ln:
                continue
            if ln in ("[info]", "[columns]", "[domains]"):
                section = ln
                continue
            if section == "[info]":
                k, _, v = ln.partition("=")
                info[k.strip()] = v.strip()
            elif section == "[columns]":
                columns.append(ln)
            elif section == "[domains]":
                ci, _, rest = ln.partition(":")
                domain_spec[int(ci)] = rest.strip().split(" ", 1)[1]
        domains = {ci: z.read(f"domains/{fn}").decode().splitlines()
                   for ci, fn in domain_spec.items()}

    cats = int(info["cats"])
    nums = int(info["nums"])
    cat_offsets = [int(v) for v in _parse_jarr(info["cat_offsets"])]
    cat_modes = [int(v) for v in _parse_jarr(info["cat_modes"])]
    num_means = _parse_jarr(info["num_means"])
    beta = _parse_jarr(info["beta"])
    use_all = info["use_all_factor_levels"] == "true"
    link = info["link"]
    tlp = float(info.get("tweedie_link_power", 0.0))

    n = len(next(iter(rows.values())))
    data = np.full((n, cats + nums), np.nan)
    for i in range(cats + nums):
        cn = columns[i]
        v = rows[cn]
        if i < cats:
            lut = {s: j for j, s in enumerate(domains[i])}
            data[:, i] = [lut.get(str(x), np.nan)
                          if x is not None else np.nan for x in v]
        else:
            data[:, i] = np.asarray(v, np.float64)

    mu = np.empty(n)
    for r in range(n):
        row = data[r].copy()
        for i in range(cats):                 # imputeMissingWithMeans
            if np.isnan(row[i]):
                row[i] = cat_modes[i]
        for i in range(nums):
            if np.isnan(row[cats + i]):
                row[cats + i] = num_means[i]
        eta = 0.0
        for i in range(cats):                 # glmScore0 cat walk
            ival = int(row[i]) - (0 if use_all else 1)
            if not use_all and row[i] == 0:
                continue
            ival += cat_offsets[i]
            if ival < cat_offsets[i + 1]:
                eta += beta[ival]
        noff = cat_offsets[cats] - cats
        for i in range(cats, len(beta) - 1 - noff):
            eta += beta[noff + i] * row[i]
        eta += beta[-1]
        if link == "identity":
            m = eta
        elif link == "logit":
            m = 1.0 / (1.0 + np.exp(-eta))
        elif link == "log":
            m = np.exp(eta)
        elif link == "inverse":
            xx = min(-1e-5, eta) if eta < 0 else max(1e-5, eta)
            m = 1.0 / xx
        elif link == "tweedie":
            m = max(2e-16, np.exp(eta)) if tlp == 0 \
                else float(np.power(eta, 1.0 / tlp))
        else:
            raise ValueError(link)
        mu[r] = m
    return mu, info


# ------------------------------------------------- reference-contract reader


def _score_tree(blob: bytes, row: np.ndarray, domains_len) -> float:
    """Byte-faithful port of SharedTreeMojoModel.scoreTree (v1.40)."""
    pos = 0

    def get1():
        nonlocal pos
        v = blob[pos]
        pos += 1
        return v

    def get2():
        nonlocal pos
        v = struct.unpack_from("<H", blob, pos)[0]
        pos += 2
        return v

    def get4f():
        nonlocal pos
        v = struct.unpack_from("<f", blob, pos)[0]
        pos += 4
        return v

    def getsize(w):
        nonlocal pos
        if w == 0:
            return get1()
        if w == 1:
            return get2()
        if w == 2:
            v = blob[pos] | (blob[pos + 1] << 8) | (blob[pos + 2] << 16)
            pos += 3
            return v
        v = struct.unpack_from("<i", blob, pos)[0]
        pos += 4
        return v

    while True:
        node_type = get1()
        col_id = get2()
        if col_id == 65535:
            return get4f()
        na_split_dir = get1()
        na_vs_rest = na_split_dir == 1
        leftward = na_split_dir in (2, 4)
        lmask = node_type & 51
        equal = node_type & 12

        split_val = None
        bs = None
        if not na_vs_rest:
            if equal == 0:
                split_val = get4f()
            else:
                if equal == 8:
                    bitoff, nbits, bs_off = 0, 32, pos
                    pos += 4
                else:
                    bitoff = get2()
                    nbits = struct.unpack_from("<i", blob, pos)[0]
                    pos += 4
                    bs_off = pos
                    pos += ((nbits - 1) >> 3) + 1
                bs = (bitoff, nbits, bs_off)

        d = row[col_id]
        out_of_bs = False
        if equal != 0 and bs is not None and not np.isnan(d):
            b = int(d) - bs[0]
            out_of_bs = not (0 <= b < bs[1])
        dlen = domains_len[col_id]
        out_of_dom = (dlen is not None and not np.isnan(d)
                      and dlen <= int(d))
        if np.isnan(d) or out_of_bs or out_of_dom:
            go_right = not leftward
        elif na_vs_rest:
            go_right = False
        elif equal == 0:
            go_right = d >= split_val
        else:
            idx = int(d) - bs[0]
            go_right = bool(blob[bs[2] + (idx >> 3)] & (1 << (idx & 7)))

        if go_right:
            if lmask <= 3:
                skip = getsize(lmask)
                pos += skip
            elif lmask == 48:
                pos += 4                     # skip the left-leaf float
            lmask = (node_type & 0xC0) >> 2
        else:
            if lmask <= 3:
                pos += lmask + 1             # skip the size field
        if lmask & 16:
            return get4f()


def score_reference_mojo(path: str, rows: Dict[str, np.ndarray]):
    """Score raw rows with a reference-layout MOJO using the ported
    reader — validates our zips honor the reference contract. Returns
    the raw per-group margins [n, n_groups_or_K] (no link applied)."""
    with zipfile.ZipFile(path) as z:
        ini = z.read("model.ini").decode().splitlines()
        info: Dict[str, str] = {}
        columns: List[str] = []
        domain_spec: Dict[int, str] = {}
        section = None
        for ln in ini:
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            if ln in ("[info]", "[columns]", "[domains]"):
                section = ln
                continue
            if section == "[info]":
                k, _, v = ln.partition("=")
                info[k.strip()] = v.strip()
            elif section == "[columns]":
                columns.append(ln)
            elif section == "[domains]":
                ci, _, rest = ln.partition(":")
                domain_spec[int(ci)] = rest.strip().split(" ", 1)[1]
        n_features = int(info["n_features"])
        n_groups = int(info["n_trees"])
        tpc = int(info["n_trees_per_class"])
        domains = {}
        for ci, fn in domain_spec.items():
            domains[ci] = z.read(f"domains/{fn}").decode().splitlines()
        # rows → double[] in column order (categoricals as domain index)
        n = len(next(iter(rows.values())))
        mat = np.full((n, n_features), np.nan)
        domains_len = [None] * n_features
        for i in range(n_features):
            cn = columns[i]
            v = rows[cn]
            if i in domains:
                lut = {s: j for j, s in enumerate(domains[i])}
                mat[:, i] = [lut.get(str(x), np.nan)
                             if x is not None else np.nan for x in v]
                domains_len[i] = len(domains[i])
            else:
                mat[:, i] = np.asarray(v, np.float64)
        out = np.zeros((n, tpc))
        for k in range(tpc):
            for g in range(n_groups):
                blob = z.read(f"trees/t{k:02d}_{g:03d}.bin")
                for r in range(n):
                    out[r, k] += _score_tree(blob, mat[r], domains_len)
        return out, info


# ------------------------------------------------- KMeans writer/reader


def write_reference_kmeans_mojo(model, path: str) -> str:
    """Reference-layout K-means MOJO (KMeansMojoReader v1.00 contract):
    model.ini kv pairs ``standardize``/``standardize_means``/
    ``standardize_mults``/``standardize_modes``/``center_num``/
    ``center_i``. Centers are written in STANDARDIZED space when
    standardize=true — KMeansMojoModel.score0 preprocesses the row with
    (x - mean) * mult before KMeans_closest. Numeric feature sets only:
    the reference handles categoricals through domain indices while our
    KMeans one-hot expands them (different geometry)."""
    if any(d is not None for d in model.di_stats["domains"]):
        raise ValueError("reference-format KMeans MOJO export covers "
                         "numeric feature sets (our KMeans one-hot "
                         "expands categoricals; the reference does not)")
    feats = list(model.features)
    centers = np.asarray(model.centers_std, np.float64)
    means = [float(m) for m in model.di_stats["num_means"]]
    sds = [float(s) if s > 0 else 1.0
           for s in model.di_stats["num_sigmas"]]
    info = _base_info(model, category="Clustering",
                      n_features=len(feats), n_classes=1,
                      n_columns=len(feats), n_domains=0)
    info.update({
        "mojo_version": "1.00",
        "algo": "kmeans",
        "algorithm": "K-means",
        "supervised": "false",
        "standardize": "true" if model.standardize else "false",
        "center_num": centers.shape[0],
    })
    if model.standardize:
        info["standardize_means"] = _jarr(means)
        info["standardize_mults"] = _jarr([1.0 / s for s in sds])
        info["standardize_modes"] = _jarr([0] * len(feats))
    for i in range(centers.shape[0]):
        info[f"center_{i}"] = _jarr([float(v) for v in centers[i]])
    return _emit_mojo_zip(path, info, feats, [None] * len(feats))


def score_reference_kmeans_mojo(path: str, rows: Dict[str, np.ndarray]):
    """Cluster assignment from a reference KMeans MOJO — the ported
    KMeansMojoModel.score0 (preprocess + KMeans_closest)."""
    info, columns, _ = _read_ini(path)
    n_feat = int(info["n_features"])
    k = int(info["center_num"])
    centers = np.stack([_parse_jarr(info[f"center_{i}"])
                        for i in range(k)])
    n = len(next(iter(rows.values())))
    mat = np.zeros((n, n_feat))
    for i in range(n_feat):
        mat[:, i] = np.asarray(rows[columns[i]], np.float64)
    if info.get("standardize") == "true":
        means = np.asarray(_parse_jarr(info["standardize_means"]))
        mults = np.asarray(_parse_jarr(info["standardize_mults"]))
        mat = (mat - means) * mults
    d2 = ((mat[:, None, :] - centers[None, :, :]) ** 2).sum(axis=2)
    return d2.argmin(axis=1), info


# ------------------------------------------- DeepLearning writer/reader


def _dl_ref_layout(model):
    """Our feature-order design vs the reference's cats-first layout.

    Returns (cats_i, nums_i, ref_to_ours): reference input unit j maps
    to our design-matrix column ref_to_ours[j]
    (DeeplearningMojoModel.score0 fills neuronsInput as [one-hot cat
    blocks..., standardized nums...]; our DataInfo expands in feature
    order)."""
    domains = model.di_stats["domains"]
    use_all = bool(model.params.get("use_all_factor_levels", True))
    first = 0 if use_all else 1
    ours = []           # per feature: list of our design column indices
    pos = 0
    for d in domains:
        if d is not None:
            kk = max(len(d), 1) - first
            ours.append(list(range(pos, pos + kk)))
            pos += kk
        else:
            ours.append([pos])
            pos += 1
    cats_i = [i for i, d in enumerate(domains) if d is not None]
    nums_i = [i for i, d in enumerate(domains) if d is None]
    ref_to_ours = []
    for i in cats_i:
        ref_to_ours += ours[i]
    for i in nums_i:
        ref_to_ours += ours[i]
    return cats_i, nums_i, ref_to_ours


def write_reference_dl_mojo(model, path: str) -> str:
    """Reference-layout DeepLearning MOJO (DeeplearningMojoReader v1.10
    contract): model.ini kv with per-layer ``weight_layerN`` (row-major
    [out, in] doubles) / ``bias_layerN``, normalization stats, and the
    cats-first input layout — first-layer weight columns are permuted
    from our feature-order design accordingly. NA categorical rows
    diverge (we encode NA as the all-zero indicator block; the reference
    imputes the mode level)."""
    from h2o3_tpu_torch.models.model import ModelCategory
    cat = model.output["category"]
    feats = list(model.features)
    domains = model.di_stats["domains"]
    cats_i, nums_i, ref_to_ours = _dl_ref_layout(model)
    use_all = bool(model.params.get("use_all_factor_levels", True))
    first = 0 if use_all else 1

    means = [float(m) for m in model.di_stats["num_means"]]
    sds = [float(s) if s > 0 else 1.0
           for s in model.di_stats["num_sigmas"]]
    cat_offsets = [0]
    for i in cats_i:
        cat_offsets.append(cat_offsets[-1]
                           + max(len(domains[i]), 1) - first)

    layers = [(np.asarray(p["W"], np.float64), np.asarray(p["b"], np.float64))
              for p in model.net]
    units = [layers[0][0].shape[0]] + [b.shape[0] for _, b in layers]

    n_classes = (model.output.get("nclasses", 1)
                 if cat in (ModelCategory.BINOMIAL,
                            ModelCategory.MULTINOMIAL) else 1)
    names = ([feats[i] for i in cats_i] + [feats[i] for i in nums_i]
             + [model.output["response"]])
    doms: List[Optional[List[str]]] = (
        [list(domains[i]) for i in cats_i] + [None] * len(nums_i)
        + [model.output.get("domain")])
    info = _base_info(model, category={
        ModelCategory.BINOMIAL: "Binomial",
        ModelCategory.MULTINOMIAL: "Multinomial"}.get(cat, "Regression"),
        n_features=len(feats), n_classes=max(n_classes, 1),
        n_columns=len(names),
        n_domains=sum(1 for d in doms if d is not None))
    dist = "bernoulli" if cat == ModelCategory.BINOMIAL else \
        ("multinomial" if cat == ModelCategory.MULTINOMIAL else "gaussian")
    info.update({
        "mojo_version": "1.10",
        "algo": "deeplearning",
        "algorithm": "Deep Learning",
        "mini_batch_size": 1,
        "nums": len(nums_i),
        "cats": len(cats_i),
        "cat_offsets": _jarr(cat_offsets),
        "norm_mul": _jarr([1.0 / s for s in sds]),
        "norm_sub": _jarr(means),
        "use_all_factor_levels": "true" if use_all else "false",
        "activation": str(model.params.get("activation", "Rectifier")),
        "mean_imputation": "false",
        "distribution": dist,
        "neural_network_sizes": _jarr(units),
        "hidden_dropout_ratios": _jarr([]),
        "_genmodel_encoding": "AUTO",
    })
    if cat == ModelCategory.REGRESSION and model.resp_stats is not None:
        mu, sd = model.resp_stats
        info["norm_resp_mul"] = _jarr([1.0 / (sd if sd else 1.0)])
        info["norm_resp_sub"] = _jarr([float(mu)])
    for li, (W, b) in enumerate(layers):
        # ours: z = x @ W ([in, out]); reference: w[out_row * in + col]
        Wr = W.T.copy()                        # [out, in]
        if li == 0:
            Wr = Wr[:, ref_to_ours]            # permute to cats-first
        info[f"weight_layer{li}"] = _jarr([float(v)
                                           for v in Wr.ravel()])
        info[f"bias_layer{li}"] = _jarr([float(v) for v in b])
    return _emit_mojo_zip(path, info, names, doms)


def _read_ini(path: str):
    with zipfile.ZipFile(path) as z:
        ini = z.read("model.ini").decode().splitlines()
        info: Dict[str, str] = {}
        columns: List[str] = []
        domain_spec: Dict[int, List[str]] = {}
        section = None
        for ln in ini:
            ln = ln.strip()
            if not ln:
                continue
            if ln in ("[info]", "[columns]", "[domains]"):
                section = ln
                continue
            if section == "[info]":
                k, _, v = ln.partition("=")
                info[k.strip()] = v.strip()
            elif section == "[columns]":
                columns.append(ln)
            elif section == "[domains]":
                ci, _, rest = ln.partition(":")
                fn = rest.strip().split(" ", 1)[1]
                domain_spec[int(ci)] = \
                    z.read(f"domains/{fn}").decode().splitlines()
    return info, columns, domain_spec


def score_reference_dl_mojo(path: str, rows: Dict[str, np.ndarray]):
    """Forward pass from a reference DL MOJO — the ported
    DeeplearningMojoModel.score0/NeuralNetwork semantics (cats-first
    input assembly, (x-sub)*mul normalization, row-major weights,
    hidden activation + linear output). Returns the raw output layer
    [n, out] plus the info dict (caller applies softmax/response
    denorm per category, as the reference's caller does)."""
    info, columns, domain_spec = _read_ini(path)
    n_cats = int(info["cats"])
    n_nums = int(info["nums"])
    cat_offsets = [int(v) for v in _parse_jarr(info["cat_offsets"])]
    norm_mul = np.asarray(_parse_jarr(info["norm_mul"]))
    norm_sub = np.asarray(_parse_jarr(info["norm_sub"]))
    use_all = info.get("use_all_factor_levels") == "true"
    units = [int(v) for v in _parse_jarr(info["neural_network_sizes"])]
    act = info.get("activation", "Rectifier").lower()

    n = len(next(iter(rows.values())))
    X = np.zeros((n, units[0]))
    first = 0 if use_all else 1
    for ci in range(n_cats):
        dom = domain_spec[ci]
        lut = {s: j for j, s in enumerate(dom)}
        codes = np.asarray([lut.get(str(v), -1)
                            for v in rows[columns[ci]]])
        base = cat_offsets[ci]
        for r in range(n):
            c = codes[r]
            if c >= first:
                X[r, base + c - first] = 1.0
    for ni in range(n_nums):
        v = np.asarray(rows[columns[n_cats + ni]], np.float64)
        X[:, cat_offsets[n_cats] + ni] = (v - norm_sub[ni]) * norm_mul[ni]

    h = X
    for li in range(len(units) - 1):
        W = np.asarray(_parse_jarr(info[f"weight_layer{li}"]))
        b = np.asarray(_parse_jarr(info[f"bias_layer{li}"]))
        W = W.reshape(units[li + 1], units[li])
        h = h @ W.T + b
        if li < len(units) - 2:
            if "tanh" in act:
                h = np.tanh(h)
            else:
                h = np.maximum(h, 0.0)
    return h, info


# ----------------------------------------- IsolationForest writer/reader


def _leaf_split_counts(is_split: np.ndarray) -> np.ndarray:
    """Per-leaf count of split nodes along its root path. Depth-major
    trees: leaf l at full depth D passes node l >> (D - d) at depth d."""
    D = is_split.shape[0]
    counts = np.zeros(2 ** D, np.float64)
    for l in range(2 ** D):
        for d in range(D):
            counts[l] += float(is_split[d][l >> (D - d)])
    return counts


def write_reference_isofor_mojo(model, path: str) -> str:
    """Reference-layout IsolationForest MOJO
    (IsolationForestMojoReader v1.40: SharedTree blobs + the
    min/max_path_length kv pair,
    hex/tree/isofor/IsolationForestMojoWriter.java:31).

    IsolationForestMojoModel.unifyPreds sums LEAF values over trees, so
    each exported leaf bakes in its full path length: the count of
    split nodes on the root path plus our stored c(n) tail correction —
    the walk then reproduces _tree_path_length exactly."""
    bm = model.bm
    f = model.forest
    feat = np.asarray(f.feat)
    thresh = np.asarray(f.thresh)
    na_left = np.asarray(f.na_left)
    is_split = np.asarray(f.is_split)
    cat_split = np.asarray(f.cat_split)
    left_words = np.asarray(f.left_words)
    leaf = np.asarray(f.leaf, np.float64)
    T, D, _ = feat.shape

    host_edges = np.asarray(bm.edges)
    edges = [e[np.isfinite(e)] for e in host_edges]
    cards = [len(d) if d else 1 for d in bm.domains]
    nb = np.asarray(bm.nbins)
    divs = [max(1, -(-cards[i] // max(int(nb[i]), 1)))
            if bm.is_cat[i] and cards[i] > int(nb[i]) else 1
            for i in range(len(cards))]

    names = list(bm.names)
    domains: List[Optional[List[str]]] = list(bm.domains)
    info = _base_info(model, category="AnomalyDetection",
                      n_features=len(names), n_classes=1,
                      n_columns=len(names),
                      n_domains=sum(1 for d in domains if d is not None))
    info.update({
        "mojo_version": "1.40",
        "algo": "isolationforest",
        "algorithm": "Isolation Forest",
        "supervised": "false",
        "n_trees": T,
        "n_trees_per_class": 1,
        "min_path_length": int(model.output.get("min_path_length", 0)),
        "max_path_length": int(model.output.get("max_path_length", 0)),
        "output_anomaly_flag": "false",
    })

    def _blobs():
        for t in range(T):
            full_leaf = leaf[t] + _leaf_split_counts(is_split[t])
            yield (f"trees/t00_{t:03d}.bin", _root_blob(
                feat[t], thresh[t], na_left[t], is_split[t],
                cat_split[t], left_words[t], full_leaf,
                edges, cards, divs, D))
    return _emit_mojo_zip(path, info, names, domains, _blobs())


def score_reference_isofor_mojo(path: str, rows: Dict[str, np.ndarray]):
    """Anomaly score + mean path length from a reference isofor MOJO —
    the ported IsolationForestMojoModel.unifyPreds."""
    tot, info = score_reference_mojo(path, rows)
    tot = tot[:, 0]
    T = int(info["n_trees"])
    mn = float(info["min_path_length"])
    mx = float(info["max_path_length"])
    score = ((mx - tot) / (mx - mn)) if mx > mn else np.ones_like(tot)
    return {"predict": score, "mean_length": tot / T}, info


# --------------------------------------------- Word2Vec writer/reader


def write_reference_word2vec_mojo(model, path: str) -> str:
    """Reference-layout Word2Vec MOJO (Word2VecMojoReader v1.00
    contract): kv vocab_size/vec_size, binary big-endian float32
    ``vectors`` blob, and a ``vocabulary`` text entry — read back via
    ByteBuffer.getFloat (big-endian) in reader order."""
    vecs = np.asarray(model.vectors, np.float32)
    vocab = list(model.vocab)
    V, Dv = vecs.shape
    info = _base_info(model, category="WordEmbedding",
                      n_features=1, n_classes=1, n_columns=1,
                      n_domains=0)
    info.update({
        "mojo_version": "1.00",
        "algo": "word2vec",
        "algorithm": "Word2Vec",
        "supervised": "false",
        "vocab_size": V,
        "vec_size": Dv,
    })
    blobs = [("vectors", vecs.astype(">f4").tobytes()),
             ("vocabulary", ("\n".join(vocab) + "\n").encode())]
    return _emit_mojo_zip(path, info, ["Word"], [None], blobs)


def read_reference_word2vec_mojo(path: str):
    """Independent decode: {word: float32[vec_size]} exactly as
    Word2VecMojoReader.readModelData builds its embeddings map."""
    info, _, _ = _read_ini(path)
    V = int(info["vocab_size"])
    Dv = int(info["vec_size"])
    with zipfile.ZipFile(path) as z:
        raw = z.read("vectors")
        vocab = z.read("vocabulary").decode().splitlines()
    if len(raw) != V * Dv * 4:
        raise IOError(f"corrupted vectors blob: {len(raw)} bytes")
    mat = np.frombuffer(raw, dtype=">f4").reshape(V, Dv)
    if len(vocab) != V:
        raise IOError(f"corrupted vocabulary: {len(vocab)} words")
    return {w: mat[i] for i, w in enumerate(vocab)}, info


def _cats_first_perm(domains_by_feat, keep_all_levels: bool):
    """Cats-first reorder shared by the CoxPH/GLRM writers: per-feature
    design-column blocks (in frame order), the categorical/numeric
    feature indices, and the design-column permutation that moves
    categorical blocks first (the MojoModel data[] layout)."""
    blocks, j = [], 0
    for d in domains_by_feat:
        if d is not None:
            w = max(len(d), 1) - (0 if keep_all_levels else 1)
        else:
            w = 1
        blocks.append(list(range(j, j + w)))
        j += w
    cats_i = [i for i, d in enumerate(domains_by_feat) if d is not None]
    nums_i = [i for i, d in enumerate(domains_by_feat) if d is None]
    perm = [c for i in cats_i for c in blocks[i]] + \
        [c for i in nums_i for c in blocks[i]]
    return blocks, cats_i, nums_i, perm, j


# ------------------------------------------------- CoxPH writer/reader


def write_reference_coxph_mojo(model, path: str) -> str:
    """Reference-layout CoxPH MOJO (CoxPHMojoReader v1.00 contract):
    coef over [cat one-hot blocks..., nums...] with cat_offsets,
    big-endian x_mean_cat/x_mean_num rectangular blobs per stratum, and
    lpBase derived BY THE READER as coef . x_mean
    (CoxPHMojoModel.computeLpBase) — so score0 returns
    lp - coef . x_mean, our centered linear predictor.

    Our design expands features in frame order; the reference wants
    categoricals first. Coefficients and the training design-column
    means (output["x_mean_design"], recorded at fit) are permuted
    accordingly. Strata/interactions are not exported (raises)."""
    if model.params.get("stratify_by"):
        raise ValueError("reference-format CoxPH MOJO export does not "
                         "cover stratified models yet")
    feats = list(model.features)
    domains_by_feat = model.di_stats["domains"]
    coef = np.asarray(model.coef, np.float64)
    xmean = np.asarray(model.output["x_mean_design"], np.float64)
    if len(xmean) != len(coef):
        raise ValueError("x_mean_design missing/stale — retrain to export")

    # our design column index blocks per feature, in feature order
    # (use_all_factor_levels=False drops the base level per block)
    blocks, cats_i, nums_i, perm, _ = _cats_first_perm(
        domains_by_feat, keep_all_levels=False)
    coef_ref = coef[perm]
    xmean_ref = xmean[perm]

    cat_offsets = [0]
    for i in cats_i:
        cat_offsets.append(cat_offsets[-1] + len(blocks[i]))
    n_cat_coef = cat_offsets[-1]

    names = [feats[i] for i in cats_i] + [feats[i] for i in nums_i]
    domains: List[Optional[List[str]]] = \
        [list(domains_by_feat[i]) for i in cats_i] + [None] * len(nums_i)
    info = _base_info(model, category="CoxPH", n_features=len(names),
                      n_classes=1, n_columns=len(names),
                      n_domains=len(cats_i))
    info.update({
        "mojo_version": "1.00",
        "algo": "coxph",
        "algorithm": "CoxPH",
        "coef": _jarr([float(v) for v in coef_ref]),
        "cats": len(cats_i),
        "cat_offsets": _jarr(cat_offsets),
        "use_all_factor_levels": "false",
        "strata_count": 0,
        "x_mean_cat_size1": 1,
        "x_mean_cat_size2": n_cat_coef,
        "x_mean_num_size1": 1,
        "x_mean_num_size2": len(coef_ref) - n_cat_coef,
        "interactions_1": "null",
        "interactions_2": "null",
        "interaction_targets": "null",
    })
    blobs = [("x_mean_cat", xmean_ref[:n_cat_coef].astype(">f8").tobytes()),
             ("x_mean_num", xmean_ref[n_cat_coef:].astype(">f8").tobytes())]
    return _emit_mojo_zip(path, info, names, domains, blobs)


def score_reference_coxph_mojo(path: str, rows: Dict[str, np.ndarray]):
    """lp from a reference CoxPH MOJO — the ported
    CoxPHMojoModel.score0 (cats-first data[], one-hot coef lookup,
    lpBase = coef . x_mean subtracted)."""
    info, columns, domain_spec = _read_ini(path)
    coef = np.asarray(_parse_jarr(info["coef"]))
    cat_offsets = [int(v) for v in _parse_jarr(info["cat_offsets"])]
    n_cats = int(info["cats"])
    with zipfile.ZipFile(path) as z:
        xm_cat = np.frombuffer(z.read("x_mean_cat"), dtype=">f8")
        xm_num = np.frombuffer(z.read("x_mean_num"), dtype=">f8")
    lp_base = float(coef[:len(xm_cat)] @ xm_cat
                    + coef[len(xm_cat):] @ xm_num)
    n = len(next(iter(rows.values())))
    lp = np.zeros(n)
    # categoricals: data[] carries the domain code; skip first level
    for ci in range(n_cats):
        dom = domain_spec[ci]
        lut = {s: j for j, s in enumerate(dom)}
        codes = np.asarray([lut.get(str(v), -1) for v in rows[columns[ci]]])
        for r in range(n):
            val = codes[r] - 1            # use_all_factor_levels=false
            x = val + cat_offsets[ci]
            if 0 <= val and x < cat_offsets[ci + 1]:
                lp[r] += coef[x]
    # numerics follow the categorical coefficient block
    for ni, cn in enumerate(columns[n_cats:]):
        v = np.asarray(rows[cn], np.float64)
        lp += coef[cat_offsets[-1] + ni] * v
    return lp - lp_base, info


# -------------------------------------------------- GLRM writer/reader


def write_reference_glrm_mojo(model, path: str) -> str:
    """Reference-layout GLRM MOJO (GlrmMojoReader v1.00+ contract):
    kv dims (ncolA/ncolY/nrowY/ncolX), regularizationX/gammaX/
    initialization, norm_sub/norm_mul, cols_permutation (cats first),
    num_levels_per_category, a ``losses`` text entry, and the
    big-endian double ``archetypes`` blob [nrowY, ncolY] read via
    ByteBuffer.getDouble; transposed=false so archetypes_raw is the
    matrix as written."""
    feats = list(model.features)
    domains_by_feat = model.di_stats["domains"]
    Y = np.asarray(model.Y, np.float64)              # [k, P_design]
    k = Y.shape[0]

    blocks, cats_i, nums_i, perm, width = _cats_first_perm(
        domains_by_feat, keep_all_levels=True)   # GLRM keeps all levels
    if width != Y.shape[1]:
        raise ValueError(
            f"GLRM archetype width {Y.shape[1]} != design width {width} "
            "(use_all_factor_levels mismatch)")
    Yref = Y[:, perm]

    num_means = [float(m) for m in model.di_stats["num_means"]]
    num_sigmas = [float(s) if s > 0 else 1.0
                  for s in model.di_stats["num_sigmas"]]
    stdize = model.transform == "standardize"
    norm_sub = num_means if stdize else [0.0] * len(nums_i)
    norm_mul = [1.0 / s for s in num_sigmas] if stdize \
        else [1.0] * len(nums_i)

    losses = ["Categorical"] * len(cats_i) + ["Quadratic"] * len(nums_i)
    names = [feats[i] for i in cats_i] + [feats[i] for i in nums_i]
    domains: List[Optional[List[str]]] = \
        [list(domains_by_feat[i]) for i in cats_i] + [None] * len(nums_i)
    info = _base_info(model, category="DimReduction",
                      n_features=len(names), n_classes=1,
                      n_columns=len(names), n_domains=len(cats_i))
    info.update({
        "mojo_version": "1.10",
        "algo": "glrm",
        "algorithm": "Generalized Low Rank Modeling",
        "supervised": "false",
        "ncolA": len(feats),
        "ncolY": Yref.shape[1],
        "nrowY": k,
        "ncolX": k,
        "regularizationX": str(model.params.get("regularization_x",
                                                "None")),
        "gammaX": float(model.params.get("gamma_x", 0.0)),
        "initialization": "PlusPlus",
        "num_categories": len(cats_i),
        "num_numeric": len(nums_i),
        "norm_sub": _jarr(norm_sub),
        "norm_mul": _jarr(norm_mul),
        "cols_permutation": _jarr(cats_i + nums_i),
        "num_levels_per_category": _jarr(
            [max(len(domains_by_feat[i]), 1) for i in cats_i]),
        "seed": int(model.params.get("seed", 0) or 0),
        "reverse_transform": "true" if stdize else "false",
        "transposed": "false",
        "catOffsets": _jarr(np.concatenate(
            [[0], np.cumsum([max(len(domains_by_feat[i]), 1)
                             for i in cats_i])]).astype(int)
            if cats_i else [0]),
    })
    blobs = [("archetypes", Yref.astype(">f8").tobytes()),
             ("losses", ("\n".join(losses) + "\n").encode())]
    return _emit_mojo_zip(path, info, names, domains, blobs)


def read_reference_glrm_mojo(path: str):
    """Independent decode of archetypes/norms/losses exactly as
    GlrmMojoReader.readModelData walks them."""
    info, columns, domain_spec = _read_ini(path)
    nrowY = int(info["nrowY"])
    ncolY = int(info["ncolY"])
    with zipfile.ZipFile(path) as z:
        arch = np.frombuffer(z.read("archetypes"),
                             dtype=">f8").reshape(nrowY, ncolY)
        losses = z.read("losses").decode().splitlines()
    return {"archetypes": arch,
            "losses": losses,
            "norm_sub": np.asarray(_parse_jarr(info["norm_sub"])),
            "norm_mul": np.asarray(_parse_jarr(info["norm_mul"])),
            "permutation": [int(v) for v in
                            _parse_jarr(info["cols_permutation"])],
            "num_levels": [int(v) for v in _parse_jarr(
                info["num_levels_per_category"])]}, info


# ------------------------------------------------- PCA writer/reader


def write_reference_pca_mojo(model, path: str) -> str:
    """Reference-layout PCA MOJO (PCAMojoReader v1.00 contract —
    hex/genmodel/algos/pca/PCAMojoReader.java:17): kv entries for
    ncats/nnums/catOffsets/permutation/normSub/normMul plus ONE
    big-endian double blob ``eigenvectors_raw`` of shape
    [eigenvector_size][k] in cats-first design order
    (PCAMojoModel.score0 walks cat one-hot blocks first, then
    (x-normSub)*normMul nums).

    Our design expands features in frame order; rows of the eigenvector
    matrix are permuted cats-first to match."""
    feats = list(model.features)
    domains_by_feat = model.di_stats["domains"]
    keep_all = bool(model.use_all_levels)
    blocks, cats_i, nums_i, perm, P = _cats_first_perm(
        domains_by_feat, keep_all_levels=keep_all)
    V = np.asarray(model.eigvecs, np.float64)          # [P, k], our order
    if V.shape[0] != P:
        raise ValueError("eigenvector rows do not match the design "
                         f"({V.shape[0]} vs {P}) — retrain to export")
    k = V.shape[1]
    V_ref = V[perm]                                    # cats-first rows

    cat_offsets = [0]
    for i in cats_i:
        cat_offsets.append(cat_offsets[-1] + len(blocks[i]))
    nnums = len(nums_i)
    if str(model.transform).lower() == "standardize":
        norm_sub = [float(m) for m in model.di_stats["num_means"]]
        # constant columns have sigma 0: emit 1.0 like the reference
        # (DataInfo.java:620 `sigma != 0 ? 1/sigma : 1`)
        norm_mul = [1.0 / float(s) if float(s) != 0.0 else 1.0
                    for s in model.di_stats["num_sigmas"]]
    else:
        norm_sub = [0.0] * nnums
        norm_mul = [1.0] * nnums

    names = [feats[i] for i in cats_i] + [feats[i] for i in nums_i]
    domains: List[Optional[List[str]]] = \
        [list(domains_by_feat[i]) for i in cats_i] + [None] * nnums
    info = _base_info(model, category="DimReduction", n_features=len(names),
                      n_classes=k, n_columns=len(names),
                      n_domains=len(cats_i))
    info.update({
        "mojo_version": "1.00",
        "algo": "pca",
        "algorithm": "Principal Component Analysis",
        "use_all_factor_levels": "true" if keep_all else "false",
        "pca_methods": str(model.params.get("pca_method", "GramSVD")),
        "pca_impl": str(model.params.get("pca_impl", "mtj_evd_symmmatrix")),
        "k": k,
        # names are emitted cats-first, so the row→cats-first map is id
        "permutation": _jarr(list(range(len(names)))),
        "ncats": len(cats_i),
        "nnums": nnums,
        "normSub": _jarr(norm_sub),
        "normMul": _jarr(norm_mul),
        "catOffsets": _jarr(cat_offsets),
        "eigenvector_size": P,
    })
    blobs = [("eigenvectors_raw", V_ref.astype(">f8").tobytes())]
    return _emit_mojo_zip(path, info, names, domains, blobs)


def score_reference_pca_mojo(path: str, rows: Dict[str, np.ndarray]):
    """Independent PCA scorer following PCAMojoModel.score0 exactly:
    cat levels index one-hot eigenvector rows (NaN/unseen skipped),
    nums project as (x - normSub) * normMul * eigenrow."""
    info, columns, domain_spec = _read_ini(path)
    k = int(info["k"])
    ncats = int(info["ncats"])
    nnums = int(info["nnums"])
    cat_offsets = [int(v) for v in _parse_jarr(info["catOffsets"])]
    permutation = [int(v) for v in _parse_jarr(info["permutation"])]
    norm_sub = np.asarray(_parse_jarr(info["normSub"]))
    norm_mul = np.asarray(_parse_jarr(info["normMul"]))
    use_all = str(info["use_all_factor_levels"]).lower() == "true"
    P = int(info["eigenvector_size"])
    with zipfile.ZipFile(path) as z:
        ev = np.frombuffer(z.read("eigenvectors_raw"),
                           dtype=">f8").reshape(P, k)
    domains = {columns[ci]: lv for ci, lv in domain_spec.items()}
    luts = {c: {s: j for j, s in enumerate(lv)}
            for c, lv in domains.items()}
    n = len(next(iter(rows.values())))
    out = np.zeros((n, k))
    for r in range(n):
        row = []
        for c in columns:
            v = rows[c][r]
            if c in luts and not (isinstance(v, float) and np.isnan(v)):
                row.append(float(luts[c].get(str(v), np.nan)))
            else:
                row.append(float(v) if v is not None else np.nan)
        acc = np.zeros(k)
        for j in range(ncats):
            tmp = row[permutation[j]]
            if np.isnan(tmp):
                continue
            last_cat = cat_offsets[j + 1] - cat_offsets[j] - 1
            level = int(tmp) - (0 if use_all else 1)
            if level < 0 or level > last_cat:
                continue
            acc += ev[cat_offsets[j] + level]
        vcol = cat_offsets[ncats]
        for j in range(nnums):
            acc += (row[permutation[ncats + j]] - norm_sub[j]) \
                * norm_mul[j] * ev[vcol + j]
        out[r] = acc
    return out


# ----------------------------------------- TargetEncoder writer/reader


def write_reference_te_mojo(model, path: str) -> str:
    """Reference-layout TargetEncoder MOJO
    (hex/genmodel/algos/targetencoder/TargetEncoderMojoReader.java:13):
    per-column ``[col]`` sections of ``level = num den`` lines in
    feature_engineering/target_encoding/encoding_map.ini (last index =
    the reserved NA level), the three columns-mapping ini files, and
    with_blending/inflection_point/smoothing kv. The reader recomputes
    priors as sum(num)/sum(den) per column (EncodingMap.getPriorMean),
    so the NA row is emitted as ``0 0`` — our fit excludes NA rows from
    the level stats and encodes NA with the prior, which the reader
    reproduces via te_column_name_to_missing_values_presence = 0."""
    p = model.params
    enc_cols = list(model.enc_maps.keys())
    emap_lines = []
    hasna_lines = []
    inenc_lines = []
    inout_lines = []
    for col in enc_cols:
        m = model.enc_maps[col]
        num = np.asarray(m["sum"], np.float64).sum(axis=0)
        den = np.asarray(m["cnt"], np.float64).sum(axis=0)
        emap_lines.append(f"[{col}]")
        for lv in range(len(num)):
            nv, dv = float(num[lv]), float(den[lv])
            nr = repr(int(nv)) if nv == int(nv) else repr(nv)
            dr = repr(int(dv)) if dv == int(dv) else repr(dv)
            emap_lines.append(f"{lv} = {nr} {dr}")
        emap_lines.append(f"{len(num)} = 0 0")      # reserved NA level
        hasna_lines.append(f"{col} = 0")
        inenc_lines += ["[from]", col, "[to]", col]
        inout_lines += ["[from]", col, "[to]", f"{col}_te"]

    names = list(enc_cols)
    domains: List[Optional[List[str]]] = \
        [list(model.enc_maps[c]["domain"]) for c in enc_cols]
    info = _base_info(model, category="TargetEncoder",
                      n_features=len(names), n_classes=1,
                      n_columns=len(names), n_domains=len(names))
    blending = bool(p.get("blending", False))
    info.update({
        "mojo_version": "1.00",
        "algo": "targetencoder",
        "algorithm": "TargetEncoder",
        "with_blending": "true" if blending else "false",
        "keep_original_categorical_columns": "true",
        "non_predictors": model.output.get("response") or "",
    })
    if blending:
        info["inflection_point"] = float(p.get("inflection_point", 10.0))
        info["smoothing"] = float(p.get("smoothing", 20.0))
    base = "feature_engineering/target_encoding"
    blobs = [
        (f"{base}/encoding_map.ini", "\n".join(emap_lines) + "\n"),
        (f"{base}/te_column_name_to_missing_values_presence.ini",
         "\n".join(hasna_lines) + "\n"),
        (f"{base}/input_encoding_columns_map.ini",
         "\n".join(inenc_lines) + "\n"),
        (f"{base}/input_output_columns_map.ini",
         "\n".join(inout_lines) + "\n"),
    ]
    return _emit_mojo_zip(path, info, names, domains,
                          [(n, b.encode()) for n, b in blobs])


def score_reference_te_mojo(path: str, rows: Dict[str, np.ndarray]):
    """Independent TE scorer following TargetEncoderMojoModel.score0:
    posterior num/den per level, optional lambda-blended toward the
    per-column prior sum(num)/sum(den); NA/unseen → prior (our export
    flags no NA level). Returns {col_te: [n]}."""
    info, columns, domain_spec = _read_ini(path)
    blending = str(info.get("with_blending", "false")).lower() == "true"
    ip = float(info.get("inflection_point", 10.0))
    sm = float(info.get("smoothing", 20.0))
    with zipfile.ZipFile(path) as z:
        emap_txt = z.read("feature_engineering/target_encoding/"
                          "encoding_map.ini").decode().splitlines()
        hasna_txt = z.read(
            "feature_engineering/target_encoding/"
            "te_column_name_to_missing_values_presence.ini"
        ).decode().splitlines()
    has_na = {}
    for ln in hasna_txt:
        if "=" in ln:
            k, _, v = ln.partition("=")
            has_na[k.strip()] = v.strip() == "1"
    emaps: Dict[str, Dict[int, tuple]] = {}
    sec = None
    for ln in emap_txt:
        ln = ln.strip()
        if not ln:
            continue
        if ln.startswith("[") and ln.endswith("]"):
            sec = ln[1:-1]
            emaps[sec] = {}
        else:
            k, _, v = ln.partition("=")
            num, den = v.strip().split(" ")
            emaps[sec][int(k)] = (float(num), float(den))
    domains = {columns[ci]: lv for ci, lv in domain_spec.items()}
    out = {}
    for col, emap in emaps.items():
        prior_num = sum(nd[0] for nd in emap.values())
        prior_den = sum(nd[1] for nd in emap.values())
        prior = prior_num / prior_den
        lv = {s: j for j, s in enumerate(domains[col])}
        vals = rows[col]
        enc = np.empty(len(vals))
        for r, v in enumerate(vals):
            isna = v is None or (isinstance(v, float) and np.isnan(v))
            cat = lv.get(str(v)) if not isna else None
            if cat is None and has_na.get(col):
                cat = max(emap)                     # reserved NA level
            if cat is None or cat not in emap or emap[cat][1] == 0:
                enc[r] = prior
                continue
            num, den = emap[cat]
            post = num / den
            if blending:
                lam = 1.0 / (1.0 + np.exp((ip - den) / sm))
                post = lam * post + (1.0 - lam) * prior
            enc[r] = post
        out[f"{col}_te"] = enc
    return out
