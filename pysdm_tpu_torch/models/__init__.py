"""model configurations: the de Jong/Mackay et al. 2023 breakup box (config
#2) and the Arabas et al. 2015 2D warm rain (config #5)"""
