"""model configurations: the coalescence-only boxes (Shima et al. 2009,
config #1; Berry 1967; Srivastava 1982; de Jong and Azimi, with its 1D
column), the thesis benchmarks (Bartman 2020, Bulenok 2023), the de
Jong/Mackay et al. 2023 breakup box (config #2), the Shipway and Hill 2012
1D column (config #4) and the Arabas et al. 2015 2D warm rain (config #5)"""
