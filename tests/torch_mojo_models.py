"""Models shared by the port's persistence, MOJO, serving and generic
tests (``tests/test_torch_{persist,genmodel,serving,generic}.py``), each
built once a test process (``functools.lru_cache``).

The reference models of the 16 algorithms the reference exports:

- GLM, DeepLearning, PCA, SVD, Isotonic, Naive Bayes, GLRM, Word2Vec,
  KMeans and the Target Encoder are fitted by the reference on a few
  hundred seeded rows, on a one-device mesh;
- the tree family (GBM, DRF, Isolation Forest, Uplift DRF, Extended
  Isolation Forest, RuleFit's forests) and CoxPH are the reference's own
  model classes built from the numpy images of the port's CPU fits of
  the same rows, in the reference's dtypes (a tree's fields int32 /
  bool / float32, its left words uint32). A JAX fit of each costs 3-12 s
  of compiling, which the suite's time cannot hold; that the two
  packages grow the same forests is what ``test_torch_{gbm,drf,isofor,
  uplift,extisofor,rulefit,coxph}.py`` hold.

``carry`` brings a reference model across with ``models/convert.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.models.tree import Tree as RefTree
from h2o3_tpu_torch.models import convert

from test_torch_isofor import _one_device

N = 400
CATS = ["g", "y", "tr"]
X = ["x0", "x1", "x2", "g"]
TREES = dict(ntrees=3, max_depth=3, seed=1)
MOJO_ALGOS = ["gbm", "drf", "isolationforest", "glm", "deeplearning", "pca",
              "svd", "isotonicregression", "coxph", "naivebayes",
              "upliftdrf", "extendedisolationforest", "glrm", "word2vec",
              "kmeans", "rulefit"]
REF_FORMAT = ["glm", "kmeans", "deeplearning", "isolationforest", "word2vec",
              "coxph", "glrm", "pca", "targetencoder", "gbm", "drf"]
IMAGES = ("gbm", "drf", "isolationforest", "upliftdrf",
          "extendedisolationforest", "rulefit", "coxph")


def cols(n=N, seed=0):
    """float32-exact numerics (so float64 binning agrees with the
    device's), a categorical with NAs, a binomial and a numeric
    response, survival columns and an uplift treatment."""
    r = np.random.RandomState(seed)
    Xn = r.randn(n, 3).astype(np.float32).astype(np.float64)
    g = np.array(["u", "v", "w"], object)[r.randint(0, 3, n)]
    g[::23] = None
    lin = Xn[:, 0] + 0.5 * Xn[:, 1] + (g == "v")
    y = (lin + 0.5 * r.randn(n) > 0).astype(int)
    return {"x0": Xn[:, 0], "x1": Xn[:, 1], "x2": Xn[:, 2], "g": g,
            "y": np.array(["n", "y"], object)[y],
            "yr": np.round(2 * Xn[:, 0] + 0.1 * r.randn(n), 3),
            "t": np.round(r.exponential(10.0, n) * np.exp(-0.3 * lin)
                          + 0.5, 2),
            "ev": (r.rand(n) < 0.7).astype(np.float64),
            "tr": np.array(["0", "1"], object)[r.randint(0, 2, n)]}


def words_cols():
    return {"words": np.asarray(["cat", "dog", "pet", None, "car", "road",
                                 "wheel", None] * 40, dtype=object)}


def ref_frame(c):
    return h2o3_tpu.Frame.from_numpy(c, categorical=[k for k in CATS
                                                     if k in c])


def port_frame(c):
    return h2o3_tpu_torch.Frame.from_numpy(
        c, categorical=[k for k in CATS if k in c], device="cpu")


@functools.lru_cache(maxsize=None)
def port_fits():
    """algo → the port's CPU fit on ``cols()`` (the images' sources)."""
    h = h2o3_tpu_torch
    fr = port_frame(cols())
    gbm = h.GBMEstimator(**TREES).train(fr, y="y", x=X)
    return {
        "gbm": gbm,
        "drf": h.DRFEstimator(**TREES).train(fr, y="y", x=X),
        "isolationforest": h.IsolationForestEstimator(
            ntrees=4, seed=1).train(fr, x=X),
        "upliftdrf": h.UpliftDRFEstimator(
            treatment_column="tr", **TREES).train(fr, y="y", x=X),
        "extendedisolationforest": h.ExtendedIsolationForestEstimator(
            ntrees=4, seed=1).train(fr, x=["x0", "x1", "x2"]),
        "rulefit": h.RuleFitEstimator(
            seed=1, min_rule_length=2, max_rule_length=2,
            rule_generation_ntrees=2).train(fr, y="y", x=X),
        "coxph": h.CoxPHEstimator(stop_column="t").train(
            fr, y="ev", x=["x0", "x1", "g"]),
    }


def _np(a):
    return a.detach().cpu().numpy() if hasattr(a, "detach") else \
        np.asarray(a)


def _ref_forest(forest):
    host = [_np(a) for a in forest]
    host[RefTree._fields.index("left_words")] = \
        host[RefTree._fields.index("left_words")].view(np.uint32)
    return RefTree(*(jnp.asarray(a) for a in host))


def _ref_bm(bm):
    from h2o3_tpu.frame.binning import BinnedMatrix
    return BinnedMatrix(
        bins=jnp.zeros((0, len(bm.names)), jnp.int8),
        nbins=jnp.asarray(_np(bm.nbins)), edges=jnp.asarray(_np(bm.edges)),
        is_cat=np.asarray(bm.is_cat, bool), names=list(bm.names),
        nbins_total=int(bm.nbins_total), nrows=0,
        domains=[None if d is None else list(d) for d in bm.domains],
        nbins_cats=int(bm.nbins_cats))


def _ref_glm(m):
    from h2o3_tpu.models.glm import Family, GLMModel
    f = m.family
    return GLMModel(dict(m.params), dict(m.output), np.asarray(m.coef),
                    Family(f.name, f.p, f.link, theta=f.theta),
                    m.di_stats, list(m.features),
                    coef_multinomial=m.coef_multinomial)


def _ref_tree_model(m):
    from h2o3_tpu.models.drf import DRFModel
    from h2o3_tpu.models.gbm import GBMModel
    if m.algo == "gbm":
        return GBMModel(dict(m.params), dict(m.output), _ref_forest(m.forest),
                        _ref_bm(m.bm), m.f0, m.dist_name)
    K = m.n_class_trees
    return DRFModel(dict(m.params), dict(m.output), _ref_forest(m.forest),
                    _ref_bm(m.bm), m.forest.feat.shape[0] // K)


def reference_image(algo):
    """The reference's model class holding the port fit's images."""
    from h2o3_tpu.models.coxph import CoxPHModel
    from h2o3_tpu.models.extisofor import ExtendedIsolationForestModel, \
        ExtTree
    from h2o3_tpu.models.isofor import IsolationForestModel
    from h2o3_tpu.models.rulefit import RuleFitModel
    from h2o3_tpu.models.uplift import UpliftDRFModel
    m = port_fits()[algo]
    p, o = dict(m.params), dict(m.output)
    if algo in ("gbm", "drf"):
        return _ref_tree_model(m)
    if algo == "isolationforest":
        return IsolationForestModel(p, o, _ref_forest(m.forest),
                                    _ref_bm(m.bm), float(m.c_norm))
    if algo == "upliftdrf":
        return UpliftDRFModel(p, o, _ref_forest(m.forest),
                              jnp.asarray(_np(m.leaf_pt)),
                              jnp.asarray(_np(m.leaf_pc)), _ref_bm(m.bm))
    if algo == "extendedisolationforest":
        f = ExtTree(*(jnp.asarray(_np(a)) for a in m.forest))
        return ExtendedIsolationForestModel(p, o, f, float(m.c_norm),
                                            list(m.means), list(m.features))
    if algo == "rulefit":
        return RuleFitModel(p, o, _ref_glm(m.glm_model),
                            [_ref_tree_model(t) for t in m.tree_models],
                            list(m.rules), list(m.linear_cols),
                            dict(m.winsor))
    return CoxPHModel(p, o, np.asarray(m.coef), m.di_stats, list(m.features))


def _fit_reference(algo, fr, wfr):
    from h2o3_tpu.models.deeplearning import DeepLearningEstimator
    from h2o3_tpu.models.glm import GLMEstimator
    from h2o3_tpu.models.glrm import GLRMEstimator
    from h2o3_tpu.models.isotonic import IsotonicRegressionEstimator
    from h2o3_tpu.models.kmeans import KMeansEstimator
    from h2o3_tpu.models.naivebayes import NaiveBayesEstimator
    from h2o3_tpu.models.pca import PCAEstimator, SVDEstimator
    from h2o3_tpu.models.targetencoder import TargetEncoderEstimator
    from h2o3_tpu.models.word2vec import Word2VecEstimator
    fits = {
        "glm": lambda: GLMEstimator(family="binomial", lambda_=0.0).train(
            fr, y="y", x=X),
        "deeplearning": lambda: DeepLearningEstimator(
            hidden=[5], epochs=1, seed=1).train(fr, y="y", x=X),
        "pca": lambda: PCAEstimator(k=2).train(fr, x=X),
        "svd": lambda: SVDEstimator(nv=2).train(fr, x=X),
        "isotonicregression": lambda: IsotonicRegressionEstimator().train(
            fr, y="yr", x=["x0"]),
        "naivebayes": lambda: NaiveBayesEstimator(laplace=1.0).train(
            fr, y="y", x=X),
        "glrm": lambda: GLRMEstimator(k=2, max_iterations=20, seed=1).train(
            fr, x=X),
        "word2vec": lambda: Word2VecEstimator(
            vec_size=4, epochs=1, min_word_freq=2, sent_sample_rate=0.0,
            seed=1).train(wfr),
        "kmeans": lambda: KMeansEstimator(k=3, seed=1).train(
            fr, x=["x0", "x1", "x2"]),
        "targetencoder": lambda: TargetEncoderEstimator(noise=0.0).train(
            fr, x=["g"], y="y"),
    }
    return fits[algo]()


@functools.lru_cache(maxsize=None)
def reference_model(algo):
    """The reference model of ``algo`` (a fit, or an image of a port
    fit)."""
    if algo in IMAGES:
        return reference_image(algo)
    with _one_device():
        return _fit_reference(algo, ref_frame(cols()),
                              ref_frame(words_cols()))


def tree_arrays(m, algo="gbm"):
    """A reference forest model's images, as models/convert.py takes
    them."""
    d = {f: np.asarray(getattr(m.forest, f)) for f in RefTree._fields}
    bm = m.bm
    d.update(edges=np.asarray(bm.edges), nbins=np.asarray(bm.nbins),
             is_cat=np.asarray(bm.is_cat), names=list(bm.names),
             domains=list(bm.domains), nbins_total=bm.nbins_total,
             nbins_cats=bm.nbins_cats, category=m.output["category"],
             domain=m.output["domain"], response=m.output["response"],
             nclasses=m.output.get("nclasses"),
             default_threshold=m.output.get("default_threshold", 0.5),
             params=dict(m.params), algo=algo)
    if algo == "gbm":
        d.update(f0=np.asarray(m.f0), dist_name=m.dist_name)
    return d


def glm_arrays(m):
    return dict(coef=np.asarray(m.coef),
                coef_multinomial=(None if m.coef_multinomial is None
                                  else np.asarray(m.coef_multinomial)),
                family=m.family.name, link=m.family.link,
                tweedie_power=float(m.family.p), theta=float(m.family.theta),
                di_stats=m.di_stats, features=list(m.features),
                output=dict(m.output), params=dict(m.params))


def carry(algo, m):
    """The reference model ``m`` carried across (models/convert.py)."""
    design = dict(di_stats=getattr(m, "di_stats", None),
                  features=getattr(m, "features", None),
                  output=dict(m.output), params=dict(m.params))
    if algo in ("gbm", "drf"):
        fn = getattr(convert, f"{algo}_model_from_arrays")
        return fn(tree_arrays(m, algo), "cpu")
    if algo == "isolationforest":
        d = tree_arrays(m, "isofor")
        d.update(c_norm=m.c_norm,
                 min_path_length=m.output.get("min_path_length"),
                 max_path_length=m.output.get("max_path_length"))
        return convert.isofor_model_from_arrays(d, "cpu")
    if algo == "upliftdrf":
        d = tree_arrays(m, "uplift")
        d.update(leaf_pt=np.asarray(m.leaf_pt), leaf_pc=np.asarray(m.leaf_pc),
                 treatment_domain=m.output["treatment_domain"])
        return convert.uplift_model_from_arrays(d, "cpu")
    if algo == "extendedisolationforest":
        f = m.forest
        return convert.extisofor_model_from_arrays(dict(
            normals=np.asarray(f.normals), offsets=np.asarray(f.offsets),
            is_split=np.asarray(f.is_split), leaf=np.asarray(f.leaf),
            means=list(m.means), features=list(m.features), c_norm=m.c_norm,
            params=dict(m.params)), "cpu")
    if algo == "glm":
        return convert.glm_model_from_arrays(glm_arrays(m))
    if algo == "deeplearning":
        return convert.deeplearning_model_from_arrays(dict(
            design, net=[{k: np.asarray(l[k]) for k in ("W", "b")}
                         for l in m.net],
            act=m.act, standardize=m.standardize, resp_stats=m.resp_stats))
    if algo == "kmeans":
        return convert.kmeans_model_from_arrays(dict(
            design, centers_std=np.asarray(m.centers_std),
            standardize=m.standardize))
    if algo in ("pca", "svd"):
        d = dict(design, transform=m.transform,
                 use_all_levels=m.use_all_levels)
        if algo == "pca":
            return convert.pca_model_from_arrays(dict(
                d, eigvecs=np.asarray(m.eigvecs)))
        return convert.svd_model_from_arrays(dict(d, V=np.asarray(m.V)))
    if algo == "glrm":
        return convert.glrm_model_from_arrays(dict(
            design, Y=np.asarray(m.Y), transform=m.transform))
    if algo == "naivebayes":
        return convert.naivebayes_model_from_arrays(dict(
            stats=m.stats, output=dict(m.output), params=dict(m.params)))
    if algo == "isotonicregression":
        return convert.isotonic_model_from_arrays(dict(
            thresholds_x=m.tx, thresholds_y=m.ty, output=dict(m.output),
            params=dict(m.params)))
    if algo == "coxph":
        return convert.coxph_model_from_arrays(dict(
            design, coef=np.asarray(m.coef)))
    if algo == "word2vec":
        return convert.word2vec_model_from_arrays(dict(
            vectors=np.asarray(m.vectors), vocab=list(m.vocab),
            output=dict(m.output), params=dict(m.params)))
    if algo == "rulefit":
        tree_algo = "drf" if m.params.get("algorithm") == "drf" else "gbm"
        return convert.rulefit_model_from_arrays(dict(
            tree_models=[tree_arrays(t, tree_algo) for t in m.tree_models],
            glm=glm_arrays(m.glm_model), rules=m.rules,
            linear_cols=m.linear_cols, winsor=m.winsor,
            output=dict(m.output), params=dict(m.params)), device="cpu")
    if algo == "targetencoder":
        return convert.targetencoder_model_from_arrays(dict(
            enc_maps=m.enc_maps, output=dict(m.output),
            params=dict(m.params)))
    raise ValueError(algo)


@functools.lru_cache(maxsize=None)
def carried(algo):
    """(the reference model of ``algo``, the port model carried
    across)."""
    m_r = reference_model(algo)
    return m_r, carry(algo, m_r)
