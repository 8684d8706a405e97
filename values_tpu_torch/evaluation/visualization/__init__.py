"""The reporting layer: the results table (LaTeX) and the bar plots
(SVG), host-only numpy (counterpart of
``values_tpu/evaluation/visualization``, without pandas, matplotlib or
seaborn)."""
