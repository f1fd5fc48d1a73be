"""ModelSchemaV3 / ModelMetrics*V3 wire producers.

The port's copy of h2o3_tpu/api/model_schema.py over the port's
``Model`` (the same ``output`` keys, metrics ``to_dict`` and ``hist``).

Reference: water/api/schemas3/ModelSchemaV3.java (model_id/parameters/
output), hex/schemas/*ModelV3, ModelMetrics*V3 (one schema per problem
type), TwoDimTableV3 (column-major data), and the thresholds table AUC2
serves (hex/AUC2.java). The real h2o-py builds its model objects straight
from this JSON (h2o-py/h2o/estimators/estimator_base.py:357
_resolve_model; metrics objects via h2o/model/metrics/__init__.py:18
make_metrics keyed on __meta.schema_name), so field names here ARE the
contract.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from h2o3_tpu_torch.models.model import Model


def twodim(name: str, col_names: List[str], col_types: List[str],
           rows: List[list], description: str = "",
           col_formats: Optional[List[str]] = None,
           row_headers: Optional[List[str]] = None) -> dict:
    """TwoDimTableV3: data is COLUMN-major on the wire
    (water/api/schemas3/TwoDimTableV3.java; h2o-py transposes it back in
    H2OTwoDimTable._parse_values). ``row_headers`` prepends the
    reference's unnamed row-header column — clients index cell_values
    positionally, so its presence must match the reference table."""
    fmts = col_formats or ["%s" if t == "string" else "%f"
                           for t in col_types]
    if row_headers is not None:
        col_names = [""] + list(col_names)
        col_types = ["string"] + list(col_types)
        fmts = ["%s"] + list(fmts)
        rows = [[str(h)] + list(r) for h, r in zip(row_headers, rows)]
    ncol = len(col_names)
    data = [[_clean(r[j]) for r in rows] for j in range(ncol)]
    return {
        "__meta": {"schema_version": 3, "schema_name": "TwoDimTableV3",
                   "schema_type": "TwoDimTable"},
        "name": name, "description": description,
        "columns": [{"__meta": {"schema_name": "ColumnSpecsBase"},
                     "name": n, "type": t, "format": f, "description": n}
                    for n, t, f in zip(col_names, col_types, fmts)],
        "rowcount": len(rows),
        "data": data,
    }


def _clean(v):
    if v is None:
        return None
    if isinstance(v, (np.generic,)):
        v = v.item()
    if isinstance(v, float) and (np.isnan(v) or np.isinf(v)):
        return None
    return v


# ---------------------------------------------------------------- binomial


def _binomial_tables(mm) -> dict:
    """thresholds_and_metric_scores + max_criteria_and_metric_scores from
    the 400-bin histogram (hex/AUC2.java column layout — index 11..14
    must be tns/fns/fps/tps, h2o-py/h2o/model/metrics/binomial.py:760)."""
    hist = getattr(mm, "hist", None)
    if hist is None:
        return {}
    pos, neg = (np.asarray(h, np.float64) for h in hist)
    nb = len(pos)
    used = np.nonzero((pos > 0) | (neg > 0))[0][::-1]   # high→low threshold
    if len(used) == 0:
        return {}
    P, N = pos.sum(), neg.sum()
    tp_c = np.cumsum(pos[::-1])[::-1]
    fp_c = np.cumsum(neg[::-1])[::-1]
    cols = ["threshold", "f1", "f2", "f0point5", "accuracy", "precision",
            "recall", "specificity", "absolute_mcc",
            "min_per_class_accuracy", "mean_per_class_accuracy",
            "tns", "fns", "fps", "tps", "tnr", "fnr", "fpr", "tpr", "idx"]
    rows = []
    for i, b in enumerate(used):
        tps, fps = tp_c[b], fp_c[b]
        fns, tns = P - tps, N - fps
        prec = tps / max(tps + fps, 1e-12)
        rec = tps / max(P, 1e-12)
        spec = tns / max(N, 1e-12)
        acc = (tps + tns) / max(P + N, 1e-12)
        f1 = 2 * prec * rec / max(prec + rec, 1e-12)
        f2 = 5 * prec * rec / max(4 * prec + rec, 1e-12)
        f05 = 1.25 * prec * rec / max(0.25 * prec + rec, 1e-12)
        denom = np.sqrt(max((tps + fps) * (tps + fns)
                            * (tns + fps) * (tns + fns), 1e-12))
        mcc = abs((tps * tns - fps * fns) / denom)
        mpca = min(rec, spec)
        rows.append([b / nb, f1, f2, f05, acc, prec, rec, spec, mcc,
                     mpca, (rec + spec) / 2,
                     tns, fns, fps, tps,
                     spec, fns / max(P, 1e-12), fps / max(N, 1e-12), rec,
                     i])
    arr = np.array([r[:-1] for r in rows], np.float64)
    crit_rows = []
    # (metric name, column index, maximize?) — reference criteria order
    for label, ci in (("max f1", 1), ("max f2", 2), ("max f0point5", 3),
                      ("max accuracy", 4), ("max precision", 5),
                      ("max recall", 6), ("max specificity", 7),
                      ("max absolute_mcc", 8),
                      ("max min_per_class_accuracy", 9),
                      ("max mean_per_class_accuracy", 10),
                      ("max tns", 11), ("max fns", 12), ("max fps", 13),
                      ("max tps", 14), ("max tnr", 15), ("max fnr", 16),
                      ("max fpr", 17), ("max tpr", 18)):
        k = int(np.argmax(arr[:, ci]))
        crit_rows.append([label, float(arr[k, 0]), float(arr[k, ci]), k])
    types = ["float64"] * 19 + ["int32"]
    return {
        "thresholds_and_metric_scores": twodim(
            "Metrics for Thresholds", cols, types, rows,
            "Binomial metrics as a function of classification thresholds"),
        "max_criteria_and_metric_scores": twodim(
            "Maximum Metrics", ["metric", "threshold", "value", "idx"],
            ["string", "float64", "float64", "int32"], crit_rows,
            "Maximum metrics at their respective thresholds"),
    }


# ---------------------------------------------------------------- metrics


_METRIC_SCHEMA = {
    "Binomial": ("ModelMetricsBinomialV3", "ModelMetricsBinomial"),
    "Multinomial": ("ModelMetricsMultinomialV3", "ModelMetricsMultinomial"),
    "Regression": ("ModelMetricsRegressionV3", "ModelMetricsRegression"),
    "Clustering": ("ModelMetricsClusteringV3", "ModelMetricsClustering"),
    "AnomalyDetection": ("ModelMetricsAnomalyV3", "ModelMetricsAnomaly"),
    "DimReduction": ("ModelMetricsPCAV3", "ModelMetricsPCA"),
    "Ordinal": ("ModelMetricsOrdinalV3", "ModelMetricsOrdinal"),
}


def metrics_v3(mm, model: Model, frame_key: str = "",
               domain: Optional[List[str]] = None) -> Optional[dict]:
    """One ModelMetrics*V3 payload."""
    if mm is None:
        return None
    d = mm.to_dict() if hasattr(mm, "to_dict") else dict(mm)
    kind = d.get("model_category") or d.get("kind") or "Regression"
    schema, stype = _METRIC_SCHEMA.get(
        kind, ("ModelMetricsRegressionV3", "ModelMetricsRegression"))
    if model.algo in ("glm", "gam") and kind in ("Binomial", "Regression",
                                                 "Multinomial"):
        schema = schema.replace("V3", "GLMV3")
        stype = stype + "GLM"
    out = {
        "__meta": {"schema_version": 3, "schema_name": schema,
                   "schema_type": stype},
        "model": {"name": model.key, "type": "Key<Model>"},
        "model_category": kind,
        "frame": {"name": frame_key, "type": "Key<Frame>"},
        "description": None,
        "scoring_time": 0,
        "MSE": _clean(d.get("MSE")), "RMSE": _clean(d.get("RMSE")),
        "nobs": int(d.get("nobs") or 0),
        "custom_metric_name": d.get("custom_metric_name"),
        "custom_metric_value": _clean(d.get("custom")),
    }
    dom = domain or d.get("domain") or model.output.get("domain")
    if kind == "Binomial":
        out.update({
            "AUC": _clean(d.get("AUC")), "pr_auc": _clean(d.get("pr_auc")),
            "Gini": _clean(d.get("Gini")),
            "logloss": _clean(d.get("logloss")),
            "mean_per_class_error": _clean(d.get("mean_per_class_error")),
            "domain": dom,
            "gains_lift_table": None,
            # present-but-None when no score histogram exists (e.g. DRF
            # with sample_rate=1.0 → no OOB rows): the client reads
            # these keys unconditionally (pyunit_no_oob_prostateRF)
            "thresholds_and_metric_scores": None,
            "max_criteria_and_metric_scores": None,
        })
        out.update(_binomial_tables(mm))
    elif kind == "Multinomial":
        cm = d.get("confusion_matrix")
        cm_table = None
        if cm is not None and dom:
            k = len(cm)
            names = list(dom) + ["Error", "Rate"]
            rows = []
            for i in range(k):
                rowsum = float(np.sum(cm[i]))
                err = 1.0 - (cm[i][i] / rowsum if rowsum else 0.0)
                wrong = int(rowsum - cm[i][i])
                rows.append(list(np.asarray(cm[i], np.float64)) +
                            [err, f"{wrong:,} / {int(rowsum):,}"])
            tot = float(np.sum(cm))
            diag = float(np.trace(np.asarray(cm)))
            rows.append([float(np.sum(np.asarray(cm)[:, j]))
                         for j in range(k)] +
                        [1.0 - diag / max(tot, 1e-12),
                         f"{int(tot - diag):,} / {int(tot):,}"])
            cm_table = twodim(
                "Confusion Matrix", names,
                ["float64"] * k + ["float64", "string"], rows,
                "Row labels: Actual class; Column labels: Predicted class")
        out.update({
            "logloss": _clean(d.get("logloss")),
            "mean_per_class_error": _clean(d.get("mean_per_class_error")),
            # multinomial AUC/AUCPR exist as fields the client probes
            # unconditionally (metrics_base.py:126); None = "not computed"
            "AUC": _clean(d.get("AUC")), "pr_auc": _clean(d.get("pr_auc")),
            "multinomial_auc_table": _multinomial_auc_table(
                d.get("multinomial_auc_rows"), "AUC"),
            "multinomial_aucpr_table": _multinomial_auc_table(
                d.get("multinomial_aucpr_rows"), "auc_pr"),
            "cm": {"__meta": {"schema_version": 3,
                              "schema_name": "ConfusionMatrixV3",
                              "schema_type": "ConfusionMatrix"},
                   "table": cm_table} if cm_table else None,
            "hit_ratio_table": None,
            "domain": dom,
        })
    elif kind == "Regression":
        out.update({
            "mae": _clean(d.get("mae")),
            "rmsle": _clean(d.get("rmsle")),
            "r2": _clean(d.get("r2")),
            "mean_residual_deviance": _clean(d.get("mean_residual_deviance")),
        })
        if model.algo in ("glm", "gam"):
            out.update({
                "null_deviance": _clean(d.get("null_deviance")),
                "residual_deviance": _clean(d.get("residual_deviance")),
                "AIC": _clean(d.get("AIC") or d.get("aic")),
                "null_degrees_of_freedom": d.get("null_degrees_of_freedom"),
                "residual_degrees_of_freedom":
                    d.get("residual_degrees_of_freedom"),
            })
    elif kind == "Clustering":
        cs = d.get("centroid_stats")
        cs_table = None
        if isinstance(cs, dict) and cs.get("size") is not None:
            sizes = cs["size"]
            wss = cs.get("within_cluster_sum_of_squares",
                         [None] * len(sizes))
            rows = [[i + 1, float(sizes[i]),
                     _clean(wss[i]) if i < len(wss) else None]
                    for i in range(len(sizes))]
            cs_table = twodim(
                "Centroid Statistics",
                ["centroid", "size", "within_cluster_sum_of_squares"],
                ["int32", "float64", "float64"], rows,
                row_headers=[str(i + 1) for i in range(len(rows))])
        out.update({
            "tot_withinss": _clean(d.get("tot_withinss")),
            "totss": _clean(d.get("totss")),
            "betweenss": _clean(d.get("betweenss")),
            "centroid_stats": cs_table,
        })
    if model.algo in ("glm", "gam") and kind == "Binomial":
        out.update({
            "null_deviance": _clean(d.get("null_deviance")),
            "residual_deviance": _clean(d.get("residual_deviance")),
            "AIC": _clean(d.get("AIC") or d.get("aic")),
            "null_degrees_of_freedom": d.get("null_degrees_of_freedom"),
            "residual_degrees_of_freedom":
                d.get("residual_degrees_of_freedom"),
        })
    # pass through anything scalar we haven't mapped (harmless extras)
    for k, v in d.items():
        if k not in out and isinstance(v, (int, float, str, type(None))):
            out[k] = _clean(v)
    return out


# ------------------------------------------------------------------ model


_CATEGORY_WIRE = {"AnomalyDetection": "AnomalyDetection"}


def _params_v3(model: Model) -> List[dict]:
    from h2o3_tpu_torch.models import get_builder
    try:
        cls = get_builder(model.algo)
        defaults = dict(getattr(cls, "DEFAULTS", {}))
    except Exception:
        defaults = {}
    hidden = set()
    try:
        hidden = set(getattr(cls, "SCHEMA_HIDDEN_PARAMS", ()))
    except Exception:
        pass
    names = sorted((set(defaults) | set(model.params)) - hidden)
    # wire spellings differ from our internal python-safe names
    wire_names = {"lambda_": "lambda",
                  "tweedie_power": "tweedie_variance_power"}
    out = [
        # pseudo-parameters every reference schema carries; clients
        # rebuild estimators from this list (pyunit_parametersKmeans
        # deletes these names explicitly)
        {"__meta": {"schema_version": 3,
                    "schema_name": "ModelParameterSchemaV3",
                    "schema_type": "Iced"},
         "name": nm, "label": nm, "help": nm, "required": False,
         "type": "Key", "default_value": None,
         "actual_value": av_, "input_value": av_,
         "level": "critical", "values": [], "gridable": False,
         "is_member_of_frames": [], "is_mutually_exclusive_with": []}
        for nm, av_ in (
            ("model_id", {"name": model.key, "type": "Key<Model>"}),
            ("training_frame",
             {"name": str(model.output.get("training_frame") or ""),
              "type": "Key<Frame>"}),
            ("validation_frame", None),
            ("max_runtime_secs", 0.0),
        ) + ((("response_column", model.output.get("response")),)
             if model.output.get("response") else ())
        if nm not in defaults and nm not in model.params]
    for n in names:
        dv = defaults.get(n)
        av = model.params.get(n, dv)
        if n == "checkpoint" and av is not None and not isinstance(av, str):
            # a donor passed as a Model object serializes as its key
            # (the wire type is Key<Model>, h2o-py sends the key string)
            av = getattr(av, "key", str(av))
        # numpy scalars (e.g. np.bool_ from grid hyper expansion) must
        # become native JSON types, not str() — a wire "False" breaks
        # pyunit expect_model_param's float(actual) coercion
        if isinstance(av, np.generic):
            av = av.item()
        if isinstance(dv, np.generic):
            dv = dv.item()
        if not isinstance(av, (int, float, str, bool, list, type(None))):
            av = str(av)
        if not isinstance(dv, (int, float, str, bool, list, type(None))):
            dv = str(dv)
        wn = wire_names.get(n, n)
        out.append({
            "__meta": {"schema_version": 3,
                       "schema_name": "ModelParameterSchemaV3",
                       "schema_type": "Iced"},
            "name": wn, "label": wn, "help": wn, "required": False,
            "type": type(av).__name__ if av is not None else "string",
            "default_value": dv, "actual_value": av,
            "input_value": av,
            "level": "critical", "values": [], "gridable": True,
            "is_member_of_frames": [], "is_mutually_exclusive_with": [],
        })
    return out


def _multinomial_auc_table(rows, metric: str) -> Optional[dict]:
    """hex/MultinomialAUC.java getTable wire twin: row headers
    '<class> vs Rest' / 'Macro OVR' / '<a> vs <b>' / 'Weighted OVO',
    columns [First class domain, Second class domain, <metric>]."""
    if not rows:
        return None
    return twodim(
        f"Multinomial {metric} values",
        ["First class domain", "Second class domain", metric],
        ["string", "string", "double"],
        [[r[1], r[2], r[3]] for r in rows],
        f"Multinomial {metric} values",
        row_headers=[r[0] for r in rows])


def _varimp_table(model: Model) -> Optional[dict]:
    vi = model.output.get("varimp")
    if not vi:
        return None
    # stored as [(name, relative)] or dicts
    rows = []
    if isinstance(vi[0], dict):
        pairs = [(v["variable"], float(v["relative_importance"]))
                 for v in vi]
    else:   # tuples (name, relative[, scaled, pct]) — extras recomputed
        pairs = [(str(t[0]), float(t[1])) for t in vi]
    total = sum(p[1] for p in pairs) or 1.0
    mx = max((p[1] for p in pairs), default=1.0) or 1.0
    for name, rel in sorted(pairs, key=lambda p: -p[1]):
        rows.append([name, rel, rel / mx, rel / total])
    return twodim("Variable Importances",
                  ["variable", "relative_importance", "scaled_importance",
                   "percentage"],
                  ["string", "float64", "float64", "float64"], rows)


def _history_table(model: Model) -> Optional[dict]:
    hist = model.output.get("scoring_history")
    if not hist:
        return None
    keys = list(hist[0].keys())
    rows = [[_clean(h.get(k)) for k in keys] for h in hist]
    types = ["string" if isinstance(rows[0][i], str) else "float64"
             for i in range(len(keys))]
    return twodim("Scoring History", keys, types, rows)


def model_to_v3(model: Model) -> dict:
    """Full ModelSchemaV3 payload for GET /3/Models/{id}."""
    out_src = model.output
    category = out_src.get("category") or "Regression"
    names = list(out_src.get("names") or [])
    response = out_src.get("response")
    domain = out_src.get("domain")
    col_names = names + ([response] if response else [])
    domains: List[Optional[List[str]]] = [None] * len(names) + \
        ([list(domain)] if response and domain else
         ([None] if response else []))
    output = {
        "__meta": {"schema_version": 3,
                   "schema_name": "ModelOutputSchemaV3",
                   "schema_type": "ModelOutput"},
        "model_category": _CATEGORY_WIRE.get(category, category),
        "names": col_names,
        "column_types": [],
        "domains": domains,
        "response_column_name": response,
        "status": "DONE",
        "start_time": 0, "end_time": 0,
        "run_time": int(out_src.get("run_time_ms") or 0),
        "default_threshold": _clean(out_src.get("default_threshold")),
        "training_metrics": metrics_v3(model.training_metrics, model),
        "validation_metrics": metrics_v3(model.validation_metrics, model),
        "cross_validation_metrics":
            metrics_v3(model.cross_validation_metrics, model),
        "cross_validation_metrics_summary": (
            twodim("Cross-Validation Metrics Summary",
                   ["mean", "sd"] + [
                       f"cv_{i + 1}_valid" for i in range(
                           int(out_src.get("cv_summary_nfolds") or 0))],
                   ["float64"] * (2 + int(out_src.get("cv_summary_nfolds")
                                          or 0)),
                   [r[1:] for r in out_src["cv_summary_rows"]],
                   row_headers=[r[0] for r in out_src["cv_summary_rows"]])
            if out_src.get("cv_summary_rows") else None),
        "cross_validation_models":
            [{"name": k, "type": "Key<Model>"} for k in
             out_src.get("cv_model_keys", [])] or None,
        "cross_validation_predictions":
            [{"name": k, "type": "Key<Frame>"} for k in
             (out_src.get("cv_predictions_keys") or [])] or None,
        "cross_validation_holdout_predictions_frame_id":
            ({"name": out_src["cv_holdout_frame_key"],
              "type": "Key<Frame>"}
             if out_src.get("cv_holdout_frame_key") else None),
        "cross_validation_fold_assignment_frame_id":
            ({"name": out_src["cv_fold_assignment_key"],
              "type": "Key<Frame>"}
             if out_src.get("cv_fold_assignment_key") else None),
        "scoring_history": _history_table(model),
        "variable_importances": _varimp_table(model),
        "model_summary": None,
        "help": {},
    }
    # DeepLearning export_weights_and_biases: frame key refs the client
    # fetches via output.weights[i].URL (h2o-py/h2o/model/model_base.py:340)
    if out_src.get("weights_keys"):
        output["weights"] = [
            {"name": k, "type": "Key<Frame>", "URL": f"/3/Frames/{k}"}
            for k in out_src["weights_keys"]]
        output["biases"] = [
            {"name": k, "type": "Key<Frame>", "URL": f"/3/Frames/{k}"}
            for k in out_src.get("biases_keys", [])]

    # GLM/GAM: coefficients_table with raw + standardized coefficients
    # (hex/glm GLMModel output; client coef()/coef_norm() read it,
    # h2o-py/h2o/model/model_base.py:685)
    if model.algo in ("glm", "gam") and getattr(model, "coef", None) \
            is not None and out_src.get("coef_names") is not None \
            and getattr(model, "coef_multinomial", None) is None \
            and out_src.get("family") != "ordinal":
        names = list(out_src["coef_names"]) + ["Intercept"]
        coefs = np.asarray(model.coef, np.float64)
        mus = np.asarray(out_src.get("coef_means") or
                         [0.0] * (len(names) - 1), np.float64)
        sds = np.asarray(out_src.get("coef_sds") or
                         [1.0] * (len(names) - 1), np.float64)
        if out_src.get("standardized"):
            from h2o3_tpu_torch.models.glm import destandardize_coefs
            std_c = coefs.copy()
            raw = destandardize_coefs(coefs, mus, sds)
        else:
            raw = coefs.copy()
            std_c = coefs.copy()
            std_c[:-1] = raw[:-1] * sds
            std_c[-1] = raw[-1] + float(np.sum(raw[:-1] * mus))
        rows = [[nm, float(rc_), float(sc_)]
                for nm, rc_, sc_ in zip(names, raw, std_c)]
        rows = [rows[-1]] + rows[:-1]     # Intercept first (reference order)
        output["coefficients_table"] = twodim(
            "Coefficients",
            ["names", "coefficients", "standardized_coefficients"],
            ["string", "float64", "float64"], rows,
            "glm coefficients")
        if output.get("variable_importances") is None:
            # GLM varimp = |standardized coefficient| (hex/glm GLMModel
            # standardized-coefficient-magnitudes table)
            mags = sorted(zip(names[:-1], np.abs(std_c[:-1])),
                          key=lambda t: -t[1])
            mx = max((m for _, m in mags), default=1.0) or 1.0
            tot = sum(m for _, m in mags) or 1.0
            output["variable_importances"] = twodim(
                "Standardized Coefficient Magnitudes",
                ["variable", "relative_importance", "scaled_importance",
                 "percentage"],
                ["string", "float64", "float64", "float64"],
                [[nm, float(m), float(m / mx), float(m / tot)]
                 for nm, m in mags])

    # multinomial GLM coefficient tables: indexed-class headers plus the
    # class-named twin (GLMModel output coefficients_table and
    # coefficients_table_multinomials_with_class_names — PUBDEV-6062)
    if model.algo in ("glm", "gam") and \
            getattr(model, "coef_multinomial", None) is not None and \
            out_src.get("coef_names") is not None and \
            out_src.get("family") != "ordinal" and \
            output.get("coefficients_table") is None:
        B = np.asarray(model.coef_multinomial, np.float64)   # [P+1, K]
        names_m = list(out_src["coef_names"]) + ["Intercept"]
        K = B.shape[1]
        mus = np.asarray(out_src.get("coef_means") or
                         [0.0] * (len(names_m) - 1), np.float64)
        sds = np.asarray(out_src.get("coef_sds") or
                         [1.0] * (len(names_m) - 1), np.float64)
        if out_src.get("standardized"):
            from h2o3_tpu_torch.models.glm import destandardize_coefs
            std_B = B
            raw_B = np.stack([destandardize_coefs(B[:, k], mus, sds)
                              for k in range(K)], axis=1)
        else:
            raw_B = B
            std_B = np.empty_like(B)
            std_B[:-1] = raw_B[:-1] * sds[:, None]
            std_B[-1] = raw_B[-1] + raw_B[:-1].T @ mus
        rows = [[nm] + [float(v) for v in raw_B[i]]
                + [float(v) for v in std_B[i]]
                for i, nm in enumerate(names_m)]
        rows = [rows[-1]] + rows[:-1]    # Intercept first
        dom = list(out_src.get("domain") or [str(k) for k in range(K)])
        types_m = ["string"] + ["float64"] * (2 * K)
        output["coefficients_table"] = twodim(
            "Coefficients",
            ["names"] + [f"coefs_class_{k}" for k in range(K)]
            + [f"std_coefs_class_{k}" for k in range(K)],
            types_m, rows, "glm multinomial coefficients")
        output["coefficients_table_multinomials_with_class_names"] = twodim(
            "Coefficients",
            ["names"] + [f"coefs_class_{d}" for d in dom]
            + [f"std_coefs_class_{d}" for d in dom],
            types_m, rows, "glm multinomial coefficients")

    # multinomial GLM varimp: mean |standardized coef| across classes
    if model.algo in ("glm", "gam") and \
            getattr(model, "coef_multinomial", None) is not None and \
            out_src.get("coef_names") is not None and \
            output.get("variable_importances") is None:
        B = np.asarray(model.coef_multinomial, np.float64)
        names_m = list(out_src["coef_names"])
        mags = sorted(zip(names_m, np.abs(B[:-1, :]).mean(axis=1)),
                      key=lambda t: -t[1])
        mx = max((m for _, m in mags), default=1.0) or 1.0
        tot = sum(m for _, m in mags) or 1.0
        output["variable_importances"] = twodim(
            "Standardized Coefficient Magnitudes",
            ["variable", "relative_importance", "scaled_importance",
             "percentage"],
            ["string", "float64", "float64", "float64"],
            [[nm, float(m), float(m / mx), float(m / tot)]
             for nm, m in mags])

    # KMeans: centers tables (client centers()/centers_std() read
    # output.centers.cell_values, h2o-py/h2o/model/models/clustering.py:233)
    if model.algo == "kmeans" and out_src.get("centers") is not None:
        cvals = out_src["centers"]
        rows = [[float(v) for v in c] for c in cvals]
        width = len(rows[0]) if rows else 0
        cand = list(out_src.get("coef_names") or [])
        if len(cand) != width:
            cand = list(out_src.get("names") or [])[:width]
        rh = [str(i + 1) for i in range(len(rows))]
        output["centers"] = twodim(
            "Cluster means", cand, ["float64"] * len(cand), rows,
            row_headers=rh)
        if out_src.get("centers_std") is not None:
            rows_s = [[float(v) for v in c]
                      for c in out_src["centers_std"]]
            output["centers_std"] = twodim(
                "Standardized cluster means", cand,
                ["float64"] * len(cand), rows_s, row_headers=rh)

    # algo-specific output extras (GLM coefficients, KMeans centers, ...)
    for k, v in out_src.items():
        if k in ("category", "names", "response", "domain", "varimp",
                 "scoring_history", "cv_model_keys"):
            continue
        if isinstance(v, (int, float, str, bool, type(None))):
            output.setdefault(k, _clean(v))
        elif isinstance(v, (list, tuple)) and (
                not v or isinstance(v[0], (int, float, str, type(None)))):
            output.setdefault(k, [_clean(x) for x in v])
    return {
        "__meta": {"schema_version": 3, "schema_name": "ModelSchemaV3",
                   "schema_type": "Model"},
        "model_id": {"name": model.key, "type": "Key<Model>",
                     "URL": f"/3/Models/{model.key}"},
        "algo": model.algo,
        "algo_full_name": model.algo.upper(),
        "response_column_name": response,
        "treatment_column_name": model.params.get("treatment_column"),
        "have_pojo": hasattr(model, "download_pojo"),
        "have_mojo": hasattr(model, "download_mojo"),
        "timestamp": 0,
        "data_frame": {"name": str(out_src.get("training_frame") or ""),
                       "type": "Key<Frame>"},
        "parameters": _params_v3(model),
        "output": output,
    }
