"""RuleFit — rules from tree ensembles and a sparse linear model.

Reference: h2o3_tpu/models/rulefit.py (hex/rulefit/RuleFit.java): tree
models at depths ``min_rule_length..max_rule_length`` (GBM, or DRF),
every root-to-leaf path a rule (a conjunction of splits), a 0/1 rule
matrix plus winsorized linear terms, and an L1 GLM with a lambda search
over them; the output is the rule importance table.

A rule is not evaluated condition by condition: each tree routes every
row once on the device (``models/tree.leaf_assignments``: the scoring
route through ``_level_goleft``), and a rule's rows are the leaf ids in
the range ``[lo, hi)`` its node covers in the complete tree. The rule
columns are built on the device from those ids, one [R, Npad] float32
block whose rows are the columns' data (padding rows 0 and NA, as a
frame pads), and their supports from one count and one fetch. A rule
column's float64 host view is made only when something reads it, from
one fetch of its whole block. The tree fits are the port's
``GBMEstimator`` / ``DRFEstimator`` fits: on the card they launch the
level kernels.

``distribution`` is accepted and inert, as in the reference. Not
ported: ``weights_column`` (the reference's RuleFit fails with it: its
GLM looks for the weights in the rule frame), multinomial responses
(the reference raises), a partitioned frame (ROADMAP A #12), MOJO and
serving (A #10).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.frame.binning import rebin_for_scoring
from h2o3_tpu_torch.frame.column import Column, column_from_numpy, T_NUM
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.model import (Model, ModelBuilder, ModelCategory,
                                         infer_category, require_local)
from h2o3_tpu_torch.models.tree import (_tree_at, leaf_assignments,
                                        level_arrays, tree_depth)
from h2o3_tpu_torch.parallel.device import fetch


def _extract_rules(forest, tree_idx: int, D: int) -> List[dict]:
    """One complete tree's root-to-leaf paths as rules with leaf-id
    ranges [lo, hi), from the forest's host arrays. Conditions are
    (feat, thresh, na_left, side, binset): binset is None for a numeric
    split, else the frozenset of the bins going left (a categorical
    subset split)."""
    # [d][idx] per field, whatever the forest's layout
    feat, thresh, na_left, is_split, cat_split, left_words = zip(
        *(level_arrays(_tree_at(forest, tree_idx), d) for d in range(D)))
    rules: List[dict] = []

    def _binset(d, idx):
        if not bool(cat_split[d][idx]):
            return None
        words = left_words[d][idx]
        return frozenset(
            int(32 * k + b) for k in range(words.shape[0])
            for b in range(32) if (int(words[k]) >> b) & 1)

    def walk(d, idx, conds):
        if d == D or not is_split[d][idx]:
            if conds:
                span = 2 ** (D - d)
                rules.append({"tree": tree_idx, "conds": list(conds),
                              "lo": idx * span, "hi": (idx + 1) * span})
            return
        f, t = int(feat[d][idx]), int(thresh[d][idx])
        nal = bool(na_left[d][idx])
        bs = _binset(d, idx)
        walk(d + 1, 2 * idx, conds + [(f, t, nal, "left", bs)])
        walk(d + 1, 2 * idx + 1, conds + [(f, t, nal, "right", bs)])

    walk(0, 0, [])
    return rules


def _rule_language(rule: dict, bm: dict) -> str:
    """A rule as text (reference Rule.languageRule); ``bm`` is the
    training binning's host fields."""
    edges = bm["edges"]
    parts = []
    for f, t, nal, side, binset in rule["conds"]:
        name = bm["names"][f]
        if bm["is_cat"][f]:
            dom = bm["domains"][f] or []
            card = max(len(dom), 1)
            nbf = int(bm["nbins"][f])
            div = -(-card // nbf) if card > nbf else 1
            if binset is not None:
                levels = [dom[i] for i in range(len(dom))
                          if (i // div) in binset]
            else:
                levels = [dom[i] for i in range(len(dom))
                          if (i // div) <= t]
            s = (f"{name} in {{{', '.join(levels)}}}" if side == "left"
                 else f"{name} not in {{{', '.join(levels)}}}")
        else:
            v = float(edges[f, t]) if t < edges.shape[1] else float("inf")
            s = f"{name} < {v:.6g}" if side == "left" else f"{name} >= {v:.6g}"
        if (side == "left") == nal:
            s += " or NA"
        parts.append(s)
    return " & ".join(parts)


def _host_forest(tm):
    """A tree model's forest on the host, in its layout (numpy arrays;
    ``left_words`` as the reference's uint32 words)."""
    out = type(tm.forest)(*(fetch(a) for a in tm.forest))
    return out._replace(left_words=out.left_words.view(np.uint32))


def _host_binning(bm) -> dict:
    return {"edges": fetch(bm.edges), "nbins": fetch(bm.nbins),
            "names": list(bm.names), "is_cat": np.asarray(bm.is_cat),
            "domains": bm.domains}


class _MaskHost:
    """The float64 host views of a block of 0/1 rule columns [R, Npad],
    made from one fetch (as bytes) on the first read."""

    def __init__(self, data: torch.Tensor, nrows: int):
        self.data, self.nrows = data, nrows
        self._host = None

    def row(self, r: int) -> np.ndarray:
        if self._host is None:
            self._host = fetch(self.data[:, :self.nrows].to(torch.uint8))
        return self._host[r].astype(np.float64)


@dataclasses.dataclass
class _RuleColumn(Column):
    """A 0/1 rule column whose host view comes from its ``_MaskHost``."""
    source: Optional[_MaskHost] = None
    index: int = 0

    def host_view(self) -> np.ndarray:
        if self.host is None:
            self.host = self.source.row(self.index)
        return self.host


def rule_masks(tm, bins: torch.Tensor, rules: List[dict]) -> torch.Tensor:
    """[R, Npad] bool: the rows in each rule of one tree model, from every
    tree's leaf ids over ``bins`` (the model's binning of a frame)."""
    nid = leaf_assignments(tm.forest, bins, tm.bm.nbins_total).T  # [T, N]
    dev = nid.device
    tree = torch.tensor([r["tree"] for r in rules], dtype=torch.long,
                        device=dev)
    lo, hi = (torch.tensor([r[k] for r in rules], dtype=torch.int32,
                           device=dev)[:, None] for k in ("lo", "hi"))
    ids = nid.index_select(0, tree)
    return (ids >= lo) & (ids < hi)


def rule_columns(masks: torch.Tensor, names: List[str],
                 frame: Frame) -> List[Column]:
    """The rule masks [R, Npad] as float32 columns of ``frame``'s rows
    (padding rows 0 and NA, one shared NA mask)."""
    valid = frame.valid_weights() > 0
    data = (masks & valid).to(torch.float32)
    source = _MaskHost(data, frame.nrows)
    return [_RuleColumn(name=nm, type=T_NUM, data=data[r], na_mask=~valid,
                        nrows=frame.nrows, source=source, index=r)
            for r, nm in enumerate(names)]


class RuleFitModel(Model):
    algo = "rulefit"

    def __init__(self, params, output, glm_model, tree_models: List,
                 rules: List[dict], linear_cols: List[str],
                 winsor: Dict[str, tuple]):
        super().__init__(params, output)
        self.glm_model = glm_model
        self.tree_models = tree_models   # one GBM/DRF model a depth
        self.rules = rules               # each: model, tree, lo/hi, name
        self.linear_cols = linear_cols
        self.winsor = winsor

    def _feature_frame(self, frame: Frame) -> Frame:
        require_local(frame, self.algo)
        cols: List[Column] = []
        for mi, tm in enumerate(self.tree_models):
            mine = [r for r in self.rules if r["model"] == mi]
            if mine:
                bm = rebin_for_scoring(tm.bm, frame)
                cols += rule_columns(rule_masks(tm, bm.bins, mine),
                                     [r["name"] for r in mine], frame)
        cols += linear_columns(frame, self.linear_cols, self.winsor)
        return Frame(cols, frame.nrows, frame.device,
                     npad=frame.nrows_padded, block=frame.block)

    def _score_raw(self, frame: Frame) -> Dict[str, np.ndarray]:
        return self.glm_model._score_raw(self._feature_frame(frame))

    def model_performance(self, frame: Frame, mask_weights=None):
        ff = self._feature_frame(frame)
        ff.add_column(frame.col(self.output["response"]))
        return self.glm_model.model_performance(ff, mask_weights)

    @property
    def rule_importance(self) -> List[dict]:
        return self.output["rule_importance"]


def linear_columns(frame: Frame, names: List[str],
                   winsor: Dict[str, tuple]) -> List[Column]:
    """``linear.<name>``: each numeric predictor clipped to its training
    winsor bounds (host numpy, as in the reference)."""
    out = []
    for n in names:
        lo, hi = winsor[n]
        out.append(column_from_numpy(
            f"linear.{n}", np.clip(frame.col(n).host_view(), lo, hi),
            frame.nrows_padded, frame.device))
    return out


class RuleFitEstimator(ModelBuilder):
    """h2o-py H2ORuleFitEstimator surface
    (h2o-py/h2o/estimators/rulefit.py). ``Lambda`` aliases ``lambda_``."""

    algo = "rulefit"
    label = "RuleFit"

    DEFAULTS = dict(
        seed=-1, algorithm="auto", min_rule_length=3, max_rule_length=3,
        max_num_rules=-1, model_type="rules_and_linear",
        rule_generation_ntrees=50, distribution="auto",
        sample_rate=0.8, nfolds=0, fold_assignment="auto",
        weights_column=None, fold_column=None, ignored_columns=None,
        lambda_=None,
    )
    PORTED = frozenset(DEFAULTS) - {"weights_column"}
    UNPORTED_WHY = {**ModelBuilder.UNPORTED_WHY, "weights_column":
                    "the reference's RuleFit fails with it (its GLM looks "
                    "for the weights column in the rule frame)"}

    def __init__(self, **params):
        if "Lambda" in params:
            params["lambda_"] = params.pop("Lambda")
        super().__init__(**params)

    def _fit(self, frame: Frame, x: Sequence[str], y: Optional[str],
             validation_frame: Optional[Frame] = None) -> Model:
        from h2o3_tpu_torch.models.drf import DRFEstimator
        from h2o3_tpu_torch.models.gbm import GBMEstimator
        from h2o3_tpu_torch.models.glm import GLMEstimator
        require_local(frame, self.label)
        p = self.params
        category = infer_category(frame, y)
        if category == ModelCategory.MULTINOMIAL:
            raise ValueError("RuleFit: multinomial not supported yet")
        seed = int(p["seed"]) if int(p["seed"]) >= 0 else 0xBEEF
        model_type = str(p["model_type"])
        depths = list(range(int(p["min_rule_length"]),
                            int(p["max_rule_length"]) + 1))
        ntrees_each = max(1, int(p["rule_generation_ntrees"])
                          // max(len(depths), 1))
        TreeEst = (DRFEstimator if str(p["algorithm"]).lower() == "drf"
                   else GBMEstimator)

        tree_models, rules = [], []
        cols: List[Column] = []
        if "rules" in model_type:
            for di, depth in enumerate(depths):
                kw = dict(ntrees=ntrees_each, max_depth=depth, seed=seed + di,
                          sample_rate=float(p["sample_rate"]))
                if TreeEst is GBMEstimator:
                    kw["learn_rate"] = 0.1
                tm = TreeEst(**kw).train(frame, y=y, x=list(x))
                tree_models.append(tm)
                forest = _host_forest(tm)
                hbm = _host_binning(tm.bm)
                T, D = forest.leaf.shape[0], tree_depth(forest)
                cand = []
                for t in range(T):
                    for r in _extract_rules(forest, t, D):
                        r["model"] = di
                        r["name"] = f"M{di}T{t}N{r['lo']}"
                        r["lang"] = _rule_language(r, hbm)
                        cand.append(r)
                if not cand:
                    continue
                masks = rule_masks(tm, tm.bm.bins, cand)
                counts = fetch(masks[:, :frame.nrows].sum(dim=1))
                keep = [i for i, c in enumerate(counts)
                        if 0 < c < frame.nrows]
                for i in keep:
                    cand[i]["support"] = float(counts[i] / frame.nrows)
                    rules.append(cand[i])
                sel = torch.tensor(keep, dtype=torch.long,
                                   device=masks.device)
                cols += rule_columns(masks.index_select(0, sel),
                                     [cand[i]["name"] for i in keep], frame)

        linear_cols: List[str] = []
        winsor: Dict[str, tuple] = {}
        if "linear" in model_type:
            for n in x:
                c = frame.col(n)
                if c.is_categorical or c.type == "string":
                    continue
                lo, hi = np.nanquantile(c.host_view(), [0.025, 0.975])
                winsor[n] = (float(lo), float(hi))
                linear_cols.append(n)
            cols += linear_columns(frame, linear_cols, winsor)
        if not cols:
            raise ValueError("RuleFit produced no features (no rules/linear)")
        ff = Frame(cols, frame.nrows, frame.device, npad=frame.nrows_padded,
                   block=frame.block)
        ff.add_column(frame.col(y))

        lam = p["lambda_"]
        gm = GLMEstimator(
            family=("binomial" if category == ModelCategory.BINOMIAL
                    else "gaussian"),
            alpha=1.0, lambda_=lam, lambda_search=lam is None, nlambdas=20,
            standardize=True).train(ff, y=y,
                                    x=[n for n in ff.names if n != y])

        # rank by |coef|; max_num_rules zeroes the tail
        coefs = gm.coefficients
        imp = [{"rule": r["lang"], "coefficient": float(coefs.get(
                    r["name"], 0.0)), "support": r["support"],
                "name": r["name"]} for r in rules]
        imp += [{"rule": f"linear({n})", "coefficient": float(coefs.get(
                     f"linear.{n}", 0.0)), "support": 1.0,
                 "name": f"linear.{n}"} for n in linear_cols]
        imp.sort(key=lambda d: -abs(d["coefficient"]))
        max_rules = int(p["max_num_rules"])
        if max_rules > 0:
            kill = {d["name"] for d in imp[max_rules:]}
            gm.coef = np.array(gm.coef)
            for i, nm in enumerate(gm.output["coef_names"]):
                if nm in kill:
                    gm.coef[i] = 0.0
            imp = imp[:max_rules]
        imp = [d for d in imp if abs(d["coefficient"]) > 1e-12]

        rc = frame.col(y)
        output = {"category": category, "response": y, "names": list(x),
                  "domain": rc.domain,
                  "nclasses": rc.cardinality if rc.is_categorical else 1,
                  "rule_importance": imp, "n_rules": len(rules),
                  "default_threshold": gm.output.get("default_threshold",
                                                     0.5)}
        model = RuleFitModel(p, output, gm, tree_models, rules, linear_cols,
                             winsor)
        model.training_metrics = gm.training_metrics
        return model
