"""Machine-learning utilities around the estimators: n-fold
cross-validation (``cv``) and probability calibration (``calibration``)."""
