"""model configurations: the coalescence-only boxes (Shima et al. 2009,
config #1; Berry 1967; Srivastava 1982; de Jong and Azimi, with its 1D
column), the thesis benchmarks (Bartman 2020, Bulenok 2023), the de
Jong/Mackay et al. 2023 breakup box (config #2), the Bieli et al. 2022
coalescence-breakup box, the Shipway and Hill 2012
1D column (config #4), the Arabas et al. 2015 2D warm rain (config #5), and
the ice models: the Alpert & Knopf 2016 freezing box and the Spichtinger et
al. 2023, Abade & Albuquerque 2024 and Niedermeier et al. 2014 mixed-phase
parcels (with the Ervens & Feingold 2012 CCN spectrum), and the parcels of
the rest of physics/: Arabas & Shima 2017, Yang et al. 2018, Jensen &
Nugent 2017 and Lowe et al. 2019, with Singer & Ward's Koehler curves"""
