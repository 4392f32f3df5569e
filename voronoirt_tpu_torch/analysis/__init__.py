"""Analysis layer of the port, the counterpart of the repo's analysis/
scripts: the figure helpers (plots.py) and the paper's regular-vs-Voronoi
line figures (line_figures.py, run as `python -m
voronoirt_tpu_torch.analysis.line_figures`).  matplotlib is imported only
inside a call that draws."""
