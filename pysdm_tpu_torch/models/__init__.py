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
Nugent 2017 and Lowe et al. 2019, with Singer & Ward's Koehler curves;
the parcels that need only what is ported: pyrcel, Grabowski & Pawlowska
2023 and Abdul-Razzak & Ghan 2000, with Rogers 1975's ODE study (host
NumPy); the Arabas et al. 2025 freezing box; the Morrison & Grabowski 2007
strato-cumulus, warm or on the mixed-phase grid; Bartman et al. 2021's
n_sd sweep of the warm rain; the seeding parcel; the aqueous-chemistry
parcels of Kreidenweis et al. 2003 and Jaruga & Pawlowska 2018; and the
isotope models: the formula studies of ``isotopes``, ``isotope_papers``,
Merlivat & Nief 1967, Van Hook 1968, Gonfiantini 1986, Jouzel & Merlivat
1984 and Gedzelman & Arnold 1994 (host NumPy), and Rozanski & Sonntag
1982's multibox over a one-drop parcel"""
