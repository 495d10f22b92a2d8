"""model configurations: the de Jong/Mackay et al. 2023 breakup box (config
#2), the Shipway and Hill 2012 1D column (config #4) and the Arabas et al.
2015 2D warm rain (config #5)"""
