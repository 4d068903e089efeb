"""Each variance-component model is a file under h100_bench/models/: the
readings of the committed models are what they were before the models
moved there (golden values), and a new model file is all the benchmark's
reference and roofline need of a new model."""
import dataclasses
import os
import shutil

import numpy as np
import pytest

from conftest import ROOT  # noqa: F401  (puts the checkout on sys.path)

from h100_bench import cohort, harness, inputs, layout, reference, work

# estimate_work of the committed cells at full size: (flops, bytes)
WORK = {"rhe_k50.streaming": (8157160000000.0, 114560800000.0),
        "genie.cached": (2583422000000.0, 47777200000.0)}

# One tiny estimate on the CPU, seed 1, request 1 (the same phenotype for
# every model): the phenotype's first values and the sum of its absolute
# values, and the full sample's sigma² (row J) from the float64 reference
# and from its TF32 control.
PHENO = [
    -0.03998328672674428, 0.018323078464778157, 1.1852842395953582,
    0.11312008282855579, 2.4881909460797167]

PHENO_ABS_SUM = 1611.7325454922302

SIGMA = {
    ('rhe_k50.cached', None): [
        0.027802463417861984, 0.06658893021746784, 0.04719288816892067,
        0.0519541047297705, 0.04024233036921569, 0.055112361843144136,
        0.055037339506807254, 0.04572316406681141, 0.6164476363916502],
    ('genie.cached', 'G'): [
        0.0253301732464888, 0.06673181621230774, 0.04339060366838599,
        0.054443942583043164, 0.045887278480137794,
        0.05417464046399199, 0.05390581230222457, 0.0488813405335509,
        0.6129746521291436],
    ('genie.cached', 'G+GxE'): [
        0.012456132484105634, 0.06731128522589098, 0.04164313613031313,
        0.05888927773530898, 0.05570804073358428, 0.048800235502316616,
        0.05410051468021664, 0.04504510520034879,
        -0.008157604987642524, 0.012611790357207662,
        0.006542983436944891, 0.0045264476929194625,
        -0.04633664122451875, 0.03351827839376646,
        -0.036950167055460795, 0.002204441594359338,
        0.05482311660336864, -0.01251822604390253,
        0.0007602141410625176, -0.021162178570865935,
        0.0077206522040736275, -0.014956733864877152,
        0.040415087267365396, 0.012548039635387365, 0.605016498446975],
    ('genie.cached', 'G+GxE+NxE'): [
        0.013542411829859364, 0.06891356198945071, 0.04278542316110371,
        0.06048230570436433, 0.05759057721813494, 0.050217474233264704,
        0.055743234378335935, 0.04662281521806322,
        -0.005945949094429366, 0.014559543891577226,
        0.008754930763869748, 0.006633123244575979,
        -0.04471930393095054, 0.03550368543064916,
        -0.03447122205233594, 0.0040411679992838475,
        0.048282086598116974, -0.020547366091818117,
        -0.0062113704548571345, -0.029324144859964305,
        -4.043108246509147e-06, -0.022580548314330085,
        0.032003753951360715, 0.0051623888436754485,
        -0.04131115088275041, 0.14871055848226775, 0.5607849419889533],
}

SIGMA_TF32 = {
    ('rhe_k50.cached', None): [
        0.02780426363675892, 0.06658989366359144, 0.04718478955117675,
        0.05196116679706884, 0.04024912037464759, 0.05510544840736576,
        0.055028515383517385, 0.04572868713687611, 0.6164495907427747],
    ('genie.cached', 'G'): [
        0.025332022859445448, 0.06672964371576583, 0.04338262184239421,
        0.05445802691830545, 0.04589892716058113, 0.054170258321418946,
        0.053897867966763754, 0.048893454901059286, 0.6129570915084274],
    ('genie.cached', 'G+GxE'): [
        0.012448952188457804, 0.06731312279088673, 0.04163813739217161,
        0.05890412865713806, 0.05572638427971935, 0.04879750449825897,
        0.05409167465085794, 0.04505939134813423, -0.00814558499352862,
        0.012614490106908363, 0.0065562183118154085,
        0.004531446087202688, -0.04635246805307575,
        0.03350587241970151, -0.03696751468891863,
        0.0021987539696590648, 0.05484910783711744,
        -0.012537621053790632, 0.0007341643501483118,
        -0.02116657305357614, 0.007710602357846419,
        -0.014950203933224533, 0.040437446340135526,
        0.012546540328776758, 0.605005910270519],
    ('genie.cached', 'G+GxE+NxE'): [
        0.013536576926708083, 0.06891686269310655,
        0.042781586983807594, 0.060499372889193756,
        0.057610884704264315, 0.0502163280189132, 0.05573599957144495,
        0.04663867973315332, -0.005936623653923853,
        0.014559268672333023, 0.008765677889215786,
        0.006634784340223078, -0.044738552837790435,
        0.03548829358488401, -0.03449208665981863,
        0.004032495501372857, 0.04830553728958919,
        -0.020569908447617115, -0.006239851610704871,
        -0.02933219930910361, -1.7514164773112108e-05,
        -0.022576839346010538, 0.032022954103460864,
        0.005157937593633216, -0.04125156363835733, 0.148766780390544,
        0.5607267411460799],
}

# Tolerances, as shares of the largest |value| compared. The genetic value
# is a float32 product, so the phenotype may differ in its last float32
# bits between BLAS builds; the float64 reference moved by at most 3e-15
# and the TF32 control by at most 3.2e-6 between 1, 3 and 8 threads, while
# TF32 rounding moves sigma² by 1.4e-5 to 1.1e-4 from float64.
TOL_PHENO, TOL_F64, TOL_TF32 = 1e-6, 1e-12, 1e-5


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) <= tol * np.max(np.abs(want))


def _tiny(cell, cache):
    """The prepared cell and the phenotype of its seed 1, request 1."""
    s = harness.prepare(cell, 1, "cpu", cache)
    return s, inputs.phenotype(cell.config, cell.traffic, 1, 1, s.g)


@pytest.mark.parametrize("name", sorted(WORK))
def test_the_work_of_each_cell_is_unchanged(name):
    cell = harness.load_cell(name)
    annot = cohort.annotation(cohort.geometry(cell.config))
    w = work.estimate_work(cell.config, cell.traffic, annot)
    assert (w["flops"], w["bytes"]) == WORK[name]


@pytest.mark.parametrize("name,gm", sorted(SIGMA, key=str),
                         ids=lambda v: str(v))
def test_the_reference_of_each_model_is_unchanged(name, gm, tiny, cache):
    cell = tiny(name, **({"genie_model": gm} if gm else {}))
    s, y = _tiny(cell, cache)
    assert _close(y[:len(PHENO), 0], PHENO, TOL_PHENO)
    assert abs(np.abs(y).sum() - PHENO_ABS_SUM) <= TOL_PHENO * PHENO_ABS_SUM
    f64 = reference.estimate(s.problem, y, "cpu")
    tf32 = reference.estimate(s.problem, y, "cpu", precision="tf32")
    assert _close(f64[0, -1], SIGMA[(name, gm)], TOL_F64)
    assert _close(tf32[0, -1], SIGMA_TF32[(name, gm)], TOL_TF32)


def test_a_new_model_file_is_enough(tiny, cache, tmp_path, monkeypatch):
    """RHE under another name, in a models directory of its own: the
    harness loads it by its name, and its reference sigma² and its work
    are RHE's exactly. (The port builds models it knows by name, so the
    copy is not run through the port.)"""
    cell = tiny("rhe_k50.cached")
    s, y = _tiny(cell, cache)
    rhe = reference.estimate(s.problem, y, "cpu")
    eye = np.eye(cell.config["num_bin"])
    rhe_work = work.estimate_work(cell.config, cell.traffic, eye)
    shutil.copytree(layout.MODELS, tmp_path / "models")
    shutil.copy(os.path.join(layout.MODELS, "rhe.py"),
                tmp_path / "models" / "rhe_alias.py")
    monkeypatch.setattr(layout, "MODELS", str(tmp_path / "models"))
    alias = {**cell.config, "model": "rhe_alias"}
    model = layout.model(alias)
    assert model.__file__ == str(tmp_path / "models" / "rhe_alias.py")
    prob = dataclasses.replace(s.problem, model=model,
                               layout=model.layout(alias))
    sigma = reference.estimate(prob, y, "cpu")
    assert sigma.tobytes() == rhe.tobytes()
    assert work.estimate_work(alias, cell.traffic, eye) == rhe_work
    monkeypatch.undo()
    assert "rhe_alias" not in layout.model_files()
