"""model configurations: the Arabas et al. 2015 2D warm rain (config #5)"""
